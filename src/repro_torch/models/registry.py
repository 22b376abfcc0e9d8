"""The model builder: every family of the JAX package from one ``ArchConfig``.

Parameters are a nested dict of tensors in the JAX package's own tree --
``embed``, ``final_norm``, ``head`` (untied only),
``groups/slot{s}/{norm1, norm2, mixer, ffn}`` (plus ``cross`` and
``norm_x`` in an encoder-decoder's slots), each leaf of a slot stacked
over ``num_groups``, and for encdec ``encoder`` (one attention + MLP slot
stacked over ``encoder_layers``) and ``enc_final_norm``.  Keeping that
layout (rather than one ``nn.Module`` per layer) makes ``models.convert``
a name-for-name copy of the JAX tree, lets the serving engine read layer
0's MoE as ``w[0]`` just as the JAX package does, and costs nothing at run
time: group g's weights are the views ``w[g]``.

A slot's mixer is ``attn`` (self-attention), ``cross`` (cross-attention
over image tokens: vlm), ``self_cross`` (self- then cross-attention over
the encoder's output: encdec), ``mamba`` (``models.ssm``: hybrid) or
``rwkv`` (``models.rwkv``, whose FFN is the channel mix: ssm).

The cache is {"pos": int, "groups": {slot: state}}, each leaf stacked over
the groups: ``k``/``v`` (G, B, T, KV, hd) for self-attention, ``mk``/``mv``
(G, B, M, KV, hd) for the memory's k/v, the list [conv, h] for mamba and
{last_x, last_cm, S} for rwkv.  Prefill and decode write the k/v caches in
place; a recurrent state or a memory's k/v replaces its leaf in the cache
dict, in the dtype the step made it in (the reference's scan stacks what
its body returns, so after a prefill these states are in the compute
dtype or f32 whatever the cache's dtype; only the self-attention k/v keep
it).  ``pos`` advances.

``loss`` is the training loss: the mean next-token NLL (chunked or fused
cross entropy) plus ``AUX_LOSS_COEF`` times the MoE load-balance loss.
With grad enabled and no cache, each layer group is re-materialised in
the backward pass when ``cfg.remat`` is set; the encoder is not (the
reference's encoder scan has no remat either).

Under a ``DeviceMesh`` (``launch.meshctx``) the same code runs sharded:
``init_cache`` places each cache leaf by ``cache_specs`` (each rank
allocating its own shard), prefill and decode write a group's slice of it
in place, and the memory (image tokens, the encoder's output) is placed
("dp", None, None).  With no ``DeviceMesh`` nothing is placed.

One departure from the reference: its cached decode stores the residual
stream as the RWKV channel mix's token-shift state (``last_cm``) where its
forward shifts the channel mix's own input, the normed stream; the port
stores that input, so its decode is its forward (ROADMAP section 3).
"""

from __future__ import annotations

import contextvars
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.blocks import resolve_device
from repro_torch.launch import meshctx
from repro_torch.launch.meshctx import maybe_shard
from repro_torch.launch.meshctx import spec as mesh_spec
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (ParamDef, cross_entropy_chunked,
                                       cross_entropy_fused, mlp_apply, mlp_defs, norm,
                                       sinusoidal_positions, tree_init, tree_shapes,
                                       tree_specs)

AUX_LOSS_COEF = 0.01


def _unbind(tree: dict) -> dict:
    """Each stacked leaf as a tuple of its per-group views (one ``unbind``
    a leaf: its backward stacks the groups' gradients once, where indexing
    each group would add G leaf-sized zero-filled tensors, O(G^2)
    traffic)."""
    return {k: _unbind(v) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}


def _take(tree, g: int):
    """Group g of a stacked tree: of each leaf (a stacked tensor, or the
    tuple of its views ``_unbind`` made) its g-th entry.  Dicts and lists
    (a mamba cache) are containers."""
    if isinstance(tree, dict):
        return {k: _take(v, g) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_take(v, g) for v in tree]
    return tree[g]


def _store(stacked, new, g: int) -> None:
    """Write group g's new state leaves into the stacked cache ``stacked``
    (a dict or a list).  A stacked leaf in another dtype than the new one
    is first replaced by a copy in the new dtype, as the reference's scan
    stacks what its body returns.  A placed leaf (a DTensor) keeps its
    placements: the new state is redistributed to them and each rank
    writes its own shard of group g in place."""
    from torch.distributed.tensor import DTensor, Shard

    for k in (new if isinstance(new, dict) else range(len(new))):
        if stacked[k].dtype != new[k].dtype:
            stacked[k] = stacked[k].to(new[k].dtype)
        if isinstance(stacked[k], DTensor):
            want = [Shard(q.dim - 1) if q.is_shard() else q for q in stacked[k].placements]
            one = new[k].redistribute(stacked[k].device_mesh, want)
            stacked[k].to_local()[g].copy_(one.to_local())
        else:
            stacked[k][g] = new[k]


@torch.library.custom_op("repro_torch::tp_out", mutates_args=())
def _tp_out(x: torch.Tensor) -> torch.Tensor:
    """The marker of a block's TP-summed output (``opt_remat_save_tp``):
    its value, a copy (a custom op may not return its input)."""
    return x.clone()


@_tp_out.register_fake
def _(x):
    return torch.empty_like(x)


#: the TP sums a block's placed output comes from, as the group's recompute
#: sees them (``maybe_shard``'s explicit redistributions)
_TP_SUMS = ("all_reduce", "reduce_scatter_tensor")


def _save_tp(ctx, op, *args, **kwargs):
    """The remat policy of ``opt_remat_save_tp`` (the reference's
    ``save_only_these_names("tp_out")``): save the marked block outputs
    and the TP sums they come from, recompute everything else.  PyTorch's
    recompute re-runs every op it does not take from the saved ones, so
    the sums are saved with the outputs they make (no collective of a TP
    sum runs twice); the weights' all-gathers run inside DTensor's ops,
    unseen here, and are recomputed (FSDP keeps no gathered weight)."""
    if op is torch.ops.repro_torch.tp_out.default or (
            getattr(op, "namespace", None) == "_c10d_functional"
            and op.__name__.split(".")[0] in _TP_SUMS):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class _TPSave(torch.autograd.Function):
    """``t`` through the ``tp_out`` marker, on each rank's own shard of a
    DTensor (placements kept); the gradient passes as it arrives (a partial
    sum stays one: no collective of its own)."""

    @staticmethod
    def forward(ctx, t):
        from torch.distributed.tensor import DTensor

        if not isinstance(t, DTensor):
            return _tp_out(t)
        return DTensor.from_local(_tp_out(t.to_local()), t.device_mesh, t.placements,
                                  run_check=False, shape=t.shape, stride=t.stride())

    @staticmethod
    def backward(ctx, grad):
        return grad


class Model:
    """Build with ``repro_torch.models.registry.build(cfg, device)``."""

    #: tokens per cross-entropy chunk; None means min(4096, B * S)
    ce_chunk: int | None = None

    def __init__(self, cfg, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.plan = self._plan()

    def _plan(self):
        plan = self.cfg.layer_plan()
        if self.cfg.family == "encdec":
            plan = [("self_cross", f) for _, f in plan]
        return plan

    # --------------------------- param defs ---------------------------------

    def _slot_defs(self, mixer: str, ffn: str) -> dict:
        cfg = self.cfg
        nd = ParamDef((cfg.d_model,), init="ones")
        slot: dict = {"norm1": nd, "norm2": nd}
        if mixer == "attn":
            slot["mixer"] = attn_lib.attn_defs(cfg)
        elif mixer == "cross":
            slot["mixer"] = attn_lib.attn_defs(cfg, cross=True)
        elif mixer == "self_cross":
            slot["mixer"] = attn_lib.attn_defs(cfg)
            slot["cross"] = attn_lib.attn_defs(cfg, cross=True)
            slot["norm_x"] = nd
        elif mixer == "mamba":
            slot["mixer"] = ssm_lib.mamba_defs(cfg)
        elif mixer == "rwkv":
            slot["mixer"] = rwkv_lib.rwkv_defs(cfg)
        else:
            raise ValueError(mixer)
        if ffn == "moe":
            slot["ffn"] = moe_lib.moe_defs(cfg)
        elif mixer == "rwkv":
            slot["ffn"] = rwkv_lib.channel_mix_defs(cfg)
        else:
            slot["ffn"] = mlp_defs(cfg.d_model, cfg.d_ff, cfg.act, cfg.mlp_bias)
        return slot

    def param_defs(self) -> dict:
        cfg = self.cfg
        d, V = cfg.d_model, cfg.vocab_size

        def stack(defs, reps):
            return {k: (ParamDef((reps,) + v.shape, v.init, (None,) + tuple(v.spec))
                        if isinstance(v, ParamDef) else stack(v, reps))
                    for k, v in defs.items()}

        defs: dict = {
            "embed": ParamDef((V, d), spec=("model", None)),
            "final_norm": ParamDef((d,), init="ones"),
            "groups": {f"slot{s}": stack(self._slot_defs(mixer, ffn), cfg.num_groups)
                       for s, (mixer, ffn) in enumerate(self.plan)},
        }
        if not cfg.tie_embeddings:
            defs["head"] = ParamDef((d, V), spec=(None, "model"))
        if cfg.family == "encdec":
            defs["encoder"] = stack(self._slot_defs("attn", "mlp"), cfg.encoder_layers)
            defs["enc_final_norm"] = ParamDef((d,), init="ones")
        return defs

    def init(self, seed: int = 0, dtype: torch.dtype = torch.float32) -> dict:
        """Random parameters on the model's device, drawn from a
        ``torch.Generator`` there seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return tree_init(self.param_defs(), gen, dtype, self.device)

    def shapes(self, dtype: torch.dtype = torch.bfloat16) -> dict:
        """The parameters as meta tensors (shapes and dtypes, no storage)."""
        return tree_shapes(self.param_defs(), dtype)

    def specs(self) -> dict:
        """Each parameter's placement tuple, in the parameters' tree."""
        return tree_specs(self.param_defs())

    # ----------------------------- caches -----------------------------------

    def _slot_cache(self, mixer: str, batch: int, max_seq: int, dtype: torch.dtype):
        cfg, dev = self.cfg, self.device
        KV, hd, G = cfg.num_kv_heads, cfg.hd, cfg.num_groups

        def kv(prefix: str, T: int) -> dict:
            return {f"{prefix}{n}": torch.zeros((G, batch, T, KV, hd), dtype=dtype, device=dev)
                    for n in ("k", "v")}

        if mixer == "attn":
            return kv("", max_seq)
        if mixer == "cross":
            return kv("m", cfg.vision_tokens)
        if mixer == "self_cross":
            return {**kv("", max_seq), **kv("m", cfg.encoder_seq)}
        def stack(t: torch.Tensor) -> torch.Tensor:
            return t.expand(G, *t.shape).contiguous()

        if mixer == "mamba":
            return [stack(t) for t in ssm_lib.mamba_init_state(cfg, batch, dtype, dev)]
        if mixer == "rwkv":
            state = rwkv_lib.rwkv_init_state(cfg, batch, dtype, dev)
            return {k: stack(t) for k, t in state.items()}
        raise ValueError(mixer)

    def init_cache(self, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        """Zeros for ``batch`` sequences of up to ``max_seq`` positions.
        Under a ``DeviceMesh`` each leaf is a DTensor placed by
        ``cache_specs`` with the dims that do not divide replicated
        (``meshctx.fitted``, the dry run's sanitizer), each rank allocating
        only its own shard."""
        if meshctx.device_mesh() is None:
            return self._init_cache(batch, max_seq, dtype)
        dev, self.device = self.device, torch.device("meta")
        try:
            shapes = self._init_cache(batch, max_seq, dtype)
        finally:
            self.device = dev

        def place(leaf, axes):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            return meshctx.zeros(tuple(leaf.shape), leaf.dtype, dev, axes)

        def walk(t, s):
            if isinstance(t, dict):
                return {k: walk(t[k], s[k]) for k in t}
            if isinstance(t, list):
                return [walk(a, b) for a, b in zip(t, s, strict=True)]
            return place(t, s)

        return walk(shapes, self.cache_specs(shapes))

    def _init_cache(self, batch, max_seq, dtype) -> dict:
        return {"pos": 0, "groups": {f"slot{s}": self._slot_cache(mixer, batch, max_seq, dtype)
                                     for s, (mixer, _) in enumerate(self.plan)}}

    def cache_specs(self, cache: dict) -> dict:
        """The placement of each leaf of ``cache`` under the active mesh
        (``launch.meshctx``), keyed by what the leaf is, as the JAX package
        keys it: the k/v caches (G, B, T, KV, hd) batch over "dp" and the
        sequence over "model" (each model shard attends to its slice of
        the sequence); RWKV's S (G, B, H, hs, hs) heads over "model";
        Mamba's conv state (G, B, dc-1, di) and h (G, B, di, ds) d_inner
        over "model"; every other leaf its batch over "dp"; ``pos`` (a
        host int) replicated."""
        def leaf(name, a) -> tuple:
            if name in ("k", "v", "mk", "mv", "S"):
                return mesh_spec(None, "dp", "model", None, None)
            if name == "conv":
                return mesh_spec(None, "dp", None, "model")
            if name == "h":
                return mesh_spec(None, "dp", "model", None)
            return mesh_spec(*([None, "dp"] + [None] * (a.dim() - 2)))

        def slot(mixer, state):
            if mixer == "mamba":  # the list [conv, h]
                return [leaf(n, a) for n, a in zip(("conv", "h"), state, strict=True)]
            return {k: leaf(k, a) for k, a in state.items()}

        return {"pos": mesh_spec(),
                "groups": {f"slot{s}": slot(mixer, cache["groups"][f"slot{s}"])
                           for s, (mixer, _) in enumerate(self.plan)}}

    # ---------------------------- forward ------------------------------------

    def _cross(self, h, memory, p, cache):
        """Cross-attention over ``memory``, or over the cache's memory k/v
        where a cached step has none: (out, the k/v to store or None)."""
        mem_kv = None
        if cache is not None and memory is None:
            mem_kv = (cache["mk"], cache["mv"])
        out, (mk, mv) = attn_lib.cross_attention(h, memory, p, self.cfg, mem_kv=mem_kv)
        return out, (None if cache is None or mem_kv is not None else {"mk": mk, "mv": mv})

    def _apply_slot(self, x, p, mixer, ffn, positions, cache, pos0, memory):
        """One layer: (x, aux, the cache leaves this step replaced).  The
        k/v caches are written in place and not returned."""
        cfg = self.cfg
        # Megatron-SP (opt_seq_parallel, training only): block outputs are
        # placed sequence-sharded over "model", so each TP sum is a
        # reduce-scatter and the norms and residual adds run sharded
        sp = cache is None and cfg.opt_seq_parallel

        save = cache is None and cfg.opt_remat_save_tp

        def out_shard(t):
            # the block's output placed: its TP sum (an all-reduce, or a
            # reduce-scatter under Megatron-SP) explicit, and marked for
            # the remat policy with opt_remat_save_tp
            t = maybe_shard(t, "dp", "model" if sp else None, None)
            return _TPSave.apply(t) if save else t

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new = {}
        h = norm(x, p["norm1"], cfg.norm)
        if mixer in ("attn", "self_cross"):
            c = None if cache is None else {"k": cache["k"], "v": cache["v"], "length": pos0}
            out = attn_lib.self_attention(h, p["mixer"], cfg, positions, cache=c)
            if mixer == "self_cross":
                x = x + out
                h = norm(x, p["norm_x"], cfg.norm)
                out, mkv = self._cross(h, memory, p["cross"], cache)
                new = mkv or {}
        elif mixer == "cross":
            out, mkv = self._cross(h, memory, p["mixer"], cache)
            new = mkv or {}
        elif mixer == "mamba":
            out, new = ssm_lib.mamba_apply(h, p["mixer"], cfg, state=cache)
        elif mixer == "rwkv":
            out, new = rwkv_lib.rwkv_apply(h, p["mixer"], cfg, state=cache)
        else:
            raise ValueError(mixer)
        x = x + out_shard(out)

        h = norm(x, p["norm2"], cfg.norm)
        if ffn == "moe":
            out, aux = moe_lib.moe_apply(h, p["ffn"], cfg)
        elif mixer == "rwkv":
            last = None if cache is None else cache["last_cm"]
            out, last_cm = rwkv_lib.channel_mix_apply(h, p["ffn"], cfg, last=last)
            if cache is not None:  # the channel mix's own input (the reference stores x)
                new["last_cm"] = last_cm
        else:
            out = mlp_apply(h, p["ffn"], cfg.act, cfg.mlp_bias)
        return x + out_shard(out), aux, new

    def _run_groups(self, x, params, positions, cache, pos0, memory):
        """The groups in order; group g reads the views ``leaf[g]`` of the
        stacked parameters and cache, and writes its new states into the
        cache's leaves (``_store``).

        With ``cfg.remat``, grad enabled and no cache, each group runs under
        ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of
        its scan body): the backward pass recomputes it, so activations
        stay about one group deep.  With ``opt_remat_save_tp`` too the
        checkpoint is selective (``_save_tp``, the reference's
        ``save_only_these_names("tp_out")``): the marked block outputs and
        their TP sums are saved, and the recompute issues no TP sum again.
        Under a mesh each
        group's output is placed ("dp", "model", None) with
        ``opt_seq_parallel`` in training (the residual stream
        sequence-sharded between blocks), ("dp", None, None) otherwise.
        The recompute may run on autograd's device thread, which does not
        see this thread's context variables (the mesh, the coded expert
        FFN's decode matrix), so both passes run in one copy of the
        forward's context.

        Under a mesh the stacked parameters' group axis is replicated, so
        ``unbind`` keeps each view's placements on the dims that remain."""
        p_views = _unbind(params["groups"])
        sp = cache is None and self.cfg.opt_seq_parallel

        def layers(x, g, memory):
            p_g = _take(p_views, g)
            c_g = _take(cache["groups"], g) if cache is not None else None
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for s, (mixer, ffn) in enumerate(self.plan):
                slot = f"slot{s}"
                x, a, new = self._apply_slot(x, p_g[slot], mixer, ffn, positions,
                                             None if c_g is None else c_g[slot], pos0, memory)
                aux = aux + a
                if new:
                    _store(cache["groups"][slot], new, g)
            return maybe_shard(x, "dp", "model" if sp else None, None), aux

        def group(x, g, memory):
            with meshctx.replicate_plain():
                return layers(x, g, memory)

        remat = self.cfg.remat and cache is None and torch.is_grad_enabled()
        ctx = contextvars.copy_context() if remat else None
        kw = {}
        if remat and self.cfg.opt_remat_save_tp:
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _save_tp)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for g in range(self.cfg.num_groups):
            if remat:
                x, a = checkpoint(ctx.run, group, x, g, memory, use_reentrant=False, **kw)
            else:
                x, a = group(x, g, memory)
            aux = aux + a
        return x, aux

    def _encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """The Whisper encoder on stub frame embeddings (B, M, d): their
        sinusoidal positions added, then ``encoder_layers`` non-causal
        attention + MLP layers and ``enc_final_norm``."""
        cfg = self.cfg
        M = frames.shape[1]
        frames = maybe_shard(frames, "dp", None, None)
        x = frames + sinusoidal_positions(M, cfg.d_model, frames.device).to(frames.dtype)
        positions = torch.arange(M, device=frames.device)
        layers = _unbind(params["encoder"])
        for layer in range(cfg.encoder_layers):
            p = _take(layers, layer)
            h = norm(x, p["norm1"], cfg.norm)
            x = x + attn_lib.self_attention(h, p["mixer"], cfg, positions, causal=False)
            h = norm(x, p["norm2"], cfg.norm)
            x = x + mlp_apply(h, p["ffn"], cfg.act, cfg.mlp_bias)
        return norm(x, params["enc_final_norm"], cfg.norm)

    def _embed(self, table, tokens):
        """The rows of ``table`` (V, d) at ``tokens``.  Under a
        ``DeviceMesh`` the table's vocab is sharded over "model": with
        grad disabled (prefill, decode) DTensor's embedding rule reads
        each rank's rows in place (an indexed lookup would move half the
        table a step); with grad, the token ids are replicated first and
        the rows indexed, since the embedding rule's partial output cannot
        take the backward's gradient and torch 2.11's DTensor refuses the
        indexed lookup's backward with sharded indices."""
        if meshctx.device_mesh() is None:
            return table[tokens.long()]
        if not torch.is_grad_enabled():  # each rank's own rows of ids first
            tokens = maybe_shard(tokens, "dp", None)
            return torch.nn.functional.embedding(tokens.long(), table)
        return table[maybe_shard(tokens, None, None).long()]

    def _positional(self, x: torch.Tensor, pos0: int) -> torch.Tensor:
        """The sinusoidal table's rows pos0..pos0+S added to x (models
        without RoPE), made alone: a step never holds the (max_seq, d)
        table."""
        S = x.shape[1]
        if pos0 + S > self.cfg.max_seq:
            raise ValueError(f"positions {pos0}..{pos0 + S - 1} run past "
                             f"max_seq {self.cfg.max_seq}")
        pe = sinusoidal_positions(S, self.cfg.d_model, self.device, start=pos0)
        return x + pe.to(x.dtype)[None]

    def forward(self, params: dict, tokens: torch.Tensor, *, extras=None,
                cache: dict | None = None):
        """tokens: (B, S) -> (hidden (B, S, d), aux, new_cache).  ``extras``:
        ``frames`` (B, encoder_seq, d) go through the encoder (encdec),
        ``vision`` (B, vision_tokens, d) is the memory (vlm); other
        families ignore them, as the reference does."""
        with meshctx.replicate_plain():
            return self._forward(params, tokens, extras, cache)

    def _forward(self, params, tokens, extras, cache):
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device)
        S = tokens.shape[1]
        x = maybe_shard(self._embed(params["embed"], tokens), "dp", None, None)
        pos0 = cache["pos"] if cache is not None else 0
        positions = pos0 + torch.arange(S, device=self.device)
        if not cfg.use_rope:
            x = self._positional(x, pos0)

        memory = None
        extras = extras or {}
        if cfg.family == "encdec" and "frames" in extras:
            memory = self._encode(params, torch.as_tensor(extras["frames"], device=self.device))
        elif cfg.family == "vlm" and "vision" in extras:
            memory = torch.as_tensor(extras["vision"], device=self.device)
        memory = maybe_shard(memory, "dp", None, None)

        x, aux = self._run_groups(x, params, positions, cache, pos0, memory)
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
        """(..., V) in f32 (f64 for an f64 model); on a mesh the batch over
        "dp" where it divides and the vocab over "model", but where a rank
        holds one row (a single sequence): its vocab is replicated, since
        DTensor's argmax over a vocab-sharded block of one row fails
        (torch 2.13, ``_nonlinear_redux``)."""
        out = x @ self.head_weight(params)
        B, bax = x.shape[0], meshctx.fit(x.shape[0], "dp")
        rows = B // meshctx.dp_size() if bax is not None else B
        return maybe_shard(out.to(torch.promote_types(out.dtype, torch.float32)),
                           bax, None, "model" if rows > 1 else None)

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
        with meshctx.replicate_plain():
            nll = ce(x.reshape(B * S, d), self.head_weight(params), labels,
                     chunk=self.ce_chunk or min(4096, B * S))
            return nll + AUX_LOSS_COEF * aux

    def prefill(self, params: dict, tokens, *, extras=None, cache: dict | None = None,
                max_seq: int | None = None,
                cache_dtype: torch.dtype = torch.bfloat16):
        """tokens: (B, S) -> (logits of the last position (B, 1, V), cache).
        ``extras`` as ``forward``'s: the memory's k/v go into the cache, so
        decode steps need none."""
        if cache is None:
            cache = self.init_cache(tokens.shape[0], max_seq or self.cfg.max_seq,
                                    cache_dtype)
        x, _, cache = self.forward(params, tokens, extras=extras, cache=cache)
        return self.logits(params, x[:, -1:]), cache

    def decode_step(self, params: dict, cache: dict, tokens):
        """tokens: (B, 1) -> (logits (B, 1, V), cache)."""
        x, _, cache = self.forward(params, tokens, cache=cache)
        return self.logits(params, x), cache


def build(cfg, device=None) -> Model:
    """The model of ``cfg`` on ``device``: None means the CUDA card and
    raises where there is none; pass ``"cpu"`` to run on the CPU, or
    ``"meta"`` for shapes without storage (the dry run)."""
    if device is not None and torch.device(device).type == "meta":
        return Model(cfg, torch.device("meta"))
    return Model(cfg, resolve_device(device))
