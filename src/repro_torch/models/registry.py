"""The model builder: the dense and MoE families from one ``ArchConfig``.

Parameters are a nested dict of tensors in the JAX package's own tree --
``embed``, ``final_norm``, ``head`` (untied only) and
``groups/slot{s}/{norm1, norm2, mixer, ffn}`` -- each leaf of a slot
stacked over ``num_groups``.  Keeping that layout (rather than one
``nn.Module`` per layer) makes ``models.convert`` a name-for-name copy of
the JAX tree, lets the serving engine read layer 0's MoE as ``w[0]`` just
as the JAX package does, and costs nothing at run time: group g's weights
are the views ``w[g]``.

The cache is {"pos": int, "groups": {slot: {"k", "v"}}}, each (G, B, T, KV,
hd); prefill and decode write its tensors in place and return it with
``pos`` advanced.

``loss`` is the training loss: the mean next-token NLL (chunked or fused
cross entropy) plus ``AUX_LOSS_COEF`` times the MoE load-balance loss.
With grad enabled and no cache, each layer group is re-materialised in
the backward pass when ``cfg.remat`` is set.

The SSM, RWKV and cross-attention mixers (the ssm, hybrid, vlm and encdec
families) and the encoder are not ported yet: they raise
``NotImplementedError`` naming ROADMAP item 5.
"""

from __future__ import annotations

import contextvars

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.blocks import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (ParamDef, cross_entropy_chunked,
                                       cross_entropy_fused, mlp_apply, mlp_defs, norm,
                                       sinusoidal_positions, tree_init)

AUX_LOSS_COEF = 0.01


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1, {item})")


_MIXER_ITEMS = {"mamba": "item 5: models/ssm.py", "rwkv": "item 5: models/rwkv.py",
                "cross": "item 5: cross-attention", "self_cross": "item 5: cross-attention"}


class Model:
    """Build with ``repro_torch.models.registry.build(cfg, device)``."""

    #: tokens per cross-entropy chunk; None means min(4096, B * S)
    ce_chunk: int | None = None

    def __init__(self, cfg, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.plan = self._plan()
        self._pe = None

    def _plan(self):
        plan = self.cfg.layer_plan()
        if self.cfg.family == "encdec":
            plan = [("self_cross", f) for _, f in plan]
        return plan

    @staticmethod
    def _check_mixer(mixer: str) -> None:
        if mixer != "attn":
            raise _not_ported(f"the {mixer!r} mixer", _MIXER_ITEMS[mixer])

    # --------------------------- param defs ---------------------------------

    def _slot_defs(self, mixer: str, ffn: str) -> dict:
        cfg = self.cfg
        self._check_mixer(mixer)
        nd = ParamDef((cfg.d_model,), init="ones")
        return {"norm1": nd, "norm2": nd, "mixer": attn_lib.attn_defs(cfg),
                "ffn": (moe_lib.moe_defs(cfg) if ffn == "moe" else
                        mlp_defs(cfg.d_model, cfg.d_ff, cfg.act, cfg.mlp_bias))}

    def param_defs(self) -> dict:
        cfg = self.cfg
        d, V, G = cfg.d_model, cfg.vocab_size, cfg.num_groups

        def stack(defs):
            return {k: (ParamDef((G,) + v.shape, v.init) if isinstance(v, ParamDef)
                        else stack(v)) for k, v in defs.items()}

        defs: dict = {
            "embed": ParamDef((V, d)),
            "final_norm": ParamDef((d,), init="ones"),
            "groups": {f"slot{s}": stack(self._slot_defs(mixer, ffn))
                       for s, (mixer, ffn) in enumerate(self.plan)},
        }
        if not cfg.tie_embeddings:
            defs["head"] = ParamDef((d, V))
        return defs

    def init(self, seed: int = 0, dtype: torch.dtype = torch.float32) -> dict:
        """Random parameters on the model's device, drawn from a
        ``torch.Generator`` there seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return tree_init(self.param_defs(), gen, dtype, self.device)

    # ----------------------------- caches -----------------------------------

    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        cfg = self.cfg
        shape = (cfg.num_groups, batch, max_seq, cfg.num_kv_heads, cfg.hd)
        groups = {}
        for s, (mixer, _) in enumerate(self.plan):
            self._check_mixer(mixer)
            groups[f"slot{s}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}
        return {"pos": 0, "groups": groups}

    # ---------------------------- forward ------------------------------------

    def _apply_slot(self, x, p, mixer, ffn, positions, cache, pos0):
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = norm(x, p["norm1"], cfg.norm)
        c = None if cache is None else {**cache, "length": pos0}
        x = x + attn_lib.self_attention(h, p["mixer"], cfg, positions, cache=c)
        h = norm(x, p["norm2"], cfg.norm)
        if ffn == "moe":
            out, aux = moe_lib.moe_apply(h, p["ffn"], cfg)
        else:
            out = mlp_apply(h, p["ffn"], cfg.act, cfg.mlp_bias)
        return x + out, aux

    def _run_groups(self, x, params, positions, cache, pos0):
        """The groups in order; group g reads the views ``leaf[g]`` of the
        stacked parameters (made by one ``unbind`` a leaf: its backward
        stacks the groups' gradients once, where indexing each group would
        add G leaf-sized zero-filled tensors, O(G^2) traffic) and cache.

        With ``cfg.remat``, grad enabled and no cache, each group runs under
        ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of
        its scan body): the backward pass recomputes it, so activations
        stay about one group deep.  ``opt_seq_parallel`` and
        ``opt_remat_save_tp`` only place shardings or name saved values in
        the reference; on one card they change no value and are plain
        remat here.  The recompute may run on autograd's device thread,
        which does not see this thread's context variables (the coded
        expert FFN's decode matrix), so both passes run in one copy of the
        forward's context."""
        def unbind(tree):
            return {k: unbind(v) if isinstance(v, dict) else v.unbind(0)
                    for k, v in tree.items()}

        def take(tree, g):
            return {k: take(v, g) if isinstance(v, dict) else v[g]
                    for k, v in tree.items()}

        p_views = unbind(params["groups"])

        def group(x, g):
            p_g = take(p_views, g)
            c_g = take(cache["groups"], g) if cache is not None else None
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for s, (mixer, ffn) in enumerate(self.plan):
                slot_c = c_g[f"slot{s}"] if c_g is not None else None
                x, a = self._apply_slot(x, p_g[f"slot{s}"], mixer, ffn,
                                        positions, slot_c, pos0)
                aux = aux + a
            return x, aux

        remat = self.cfg.remat and cache is None and torch.is_grad_enabled()
        ctx = contextvars.copy_context() if remat else None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for g in range(self.cfg.num_groups):
            if remat:
                x, a = checkpoint(ctx.run, group, x, g, use_reentrant=False)
            else:
                x, a = group(x, g)
            aux = aux + a
        return x, aux

    def _encode(self, params, frames):
        raise _not_ported("the encoder (encdec family)", "item 5: cross-attention")

    def _positional(self, x: torch.Tensor, pos0: int) -> torch.Tensor:
        """The sinusoidal table's rows pos0..pos0+S added to x (models
        without RoPE); the table is made once per model."""
        S = x.shape[1]
        if pos0 + S > self.cfg.max_seq:
            raise ValueError(f"positions {pos0}..{pos0 + S - 1} run past "
                             f"max_seq {self.cfg.max_seq}")
        if self._pe is None:
            self._pe = sinusoidal_positions(self.cfg.max_seq, self.cfg.d_model,
                                            self.device)
        return x + self._pe[pos0:pos0 + S].to(x.dtype)[None]

    def forward(self, params: dict, tokens: torch.Tensor, *, extras=None,
                cache: dict | None = None):
        """tokens: (B, S) -> (hidden (B, S, d), aux, new_cache)."""
        cfg = self.cfg
        if extras:
            raise _not_ported(f"inputs {sorted(extras)}", "item 5: cross-attention")
        tokens = torch.as_tensor(tokens, device=self.device)
        S = tokens.shape[1]
        x = params["embed"][tokens.long()]
        pos0 = cache["pos"] if cache is not None else 0
        positions = pos0 + torch.arange(S, device=self.device)
        if not cfg.use_rope:
            x = self._positional(x, pos0)
        x, aux = self._run_groups(x, params, positions, cache, pos0)
        x = norm(x, params["final_norm"], cfg.norm)
        new_cache = None
        if cache is not None:
            new_cache = {"pos": pos0 + S, "groups": cache["groups"]}
        return x, aux, new_cache

    # ------------------------------ heads ------------------------------------

    def head_weight(self, params: dict) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["head"]

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return (x @ self.head_weight(params)).float()

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        """batch: tokens (B, S), labels (B, S) (-1: no label) -> the mean
        NLL plus ``AUX_LOSS_COEF`` x the MoE aux loss, f32.  The fused
        cross entropy with ``opt_fused_ce``, the chunked one otherwise,
        over chunks of ``ce_chunk`` or min(4096, B * S) tokens."""
        extras = {k: v for k, v in batch.items() if k in ("frames", "vision")}
        x, aux, _ = self.forward(params, batch["tokens"], extras=extras)
        B, S, d = x.shape
        ce = cross_entropy_fused if self.cfg.opt_fused_ce else cross_entropy_chunked
        labels = torch.as_tensor(batch["labels"], device=self.device).reshape(-1)
        nll = ce(x.reshape(B * S, d), self.head_weight(params), labels,
                 chunk=self.ce_chunk or min(4096, B * S))
        return nll + AUX_LOSS_COEF * aux

    def prefill(self, params: dict, tokens, *, cache: dict | None = None,
                max_seq: int | None = None,
                cache_dtype: torch.dtype = torch.bfloat16):
        """tokens: (B, S) -> (logits of the last position (B, 1, V), cache)."""
        if cache is None:
            cache = self.init_cache(tokens.shape[0], max_seq or self.cfg.max_seq,
                                    cache_dtype)
        x, _, cache = self.forward(params, tokens, cache=cache)
        return self.logits(params, x[:, -1:]), cache

    def decode_step(self, params: dict, cache: dict, tokens):
        """tokens: (B, 1) -> (logits (B, 1, V), cache)."""
        x, _, cache = self.forward(params, tokens, cache=cache)
        return self.logits(params, x), cache


def build(cfg, device=None) -> Model:
    """The model of ``cfg`` on ``device``: None means the CUDA card and
    raises where there is none; pass ``"cpu"`` to run on the CPU."""
    return Model(cfg, resolve_device(device))
