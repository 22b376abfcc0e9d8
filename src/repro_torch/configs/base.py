"""Architecture configuration schema (the port's copy of the JAX package's).

Every assigned architecture is an ``ArchConfig``.  The model builder
(``repro_torch.models.registry``) consumes only this schema, so new
architectures are pure config additions.  ``reduced()`` yields the small
same-family variant the CPU tests run.  The fields, defaults and rules are
the JAX package's, so the two registries hold the same names and fields;
``coded`` is the port's own ``CodedMatmulConfig``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.coded.config import CodedMatmulConfig


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                 # per-expert hidden width
    every: int = 1            # MoE on every k-th layer (jamba: 2), else dense MLP
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int           # decoder layers for encdec
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                 # dense-MLP hidden width (MoE archs: see moe.d_ff)
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // num_heads
    qkv_bias: bool = False
    mlp_bias: bool = False
    norm: str = "rmsnorm"     # rmsnorm | layernorm
    act: str = "silu"         # silu (swiglu) | gelu (plain MLP)
    use_rope: bool = True
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: bool = False
    rwkv_head_size: int = 64
    attn_every: int = 1       # 1 = attention in every layer; jamba: 8
    cross_attn_every: int = 0  # vlm: every k-th layer is cross-attention
    encoder_layers: int = 0   # encdec only
    encoder_seq: int = 1500   # whisper frame embeddings (stub frontend)
    vision_tokens: int = 1024  # vlm patch embeddings (stub frontend)
    max_seq: int = 32_768
    sub_quadratic: bool = False  # may run long_500k
    remat: bool = True        # activation checkpointing per layer group
    source: str = ""          # provenance note [paper/hf; tier]

    # ---- framework optimization flags (default OFF = the recorded baseline;
    # ---- EXPERIMENTS.md section Perf measures each; see launch/roofline.py --opt)
    opt_fused_ce: bool = False         # hand-written CE backward (no dlogits AG)
    opt_moe_local_dispatch: bool = False  # dp-chunk-local MoE pack (no scatter replication)
    opt_onehot_cache: bool = False     # one-hot KV-cache update (no DUS gathers)
    opt_serving_layout: bool = False   # decode-time weight layout: shard the
    #   contraction dim over 'data' so per-token matmuls psum tiny partials
    #   instead of all-gathering FSDP-sharded weights every step
    opt_seq_parallel: bool = False     # sequence-sharded residual stream (train)
    opt_remat_save_tp: bool = False    # remat policy: save TP-psum'd block
    #   outputs so the backward recompute does not re-run forward all-reduces
    opt_moe_shardmap_combine: bool = False  # hand-written shard_map MoE
    #   combine: sum each expert shard's contributions locally, psum ONE
    #   (Tl, d) bf16 tensor (vs GSPMD's (Tl*k, d) f32 gather-AR)
    opt_coded_moe: bool = False        # coded expert FFN matmuls: every MoE
    #   expert product is encoded over `coded_moe_workers` redundant workers
    #   with the scheme in `coded` and decoded linearly, so generation
    #   tolerates dead/slow expert shards (models/moe.py, DESIGN.md s.11)
    coded_moe_workers: int = 0         # workers for the expert code; 0 ->
    #   num_experts + 2 (two redundant rows, the paper's minimal slack)
    # ---- coded-matmul deployment (repro_torch.coded) --------------------------------
    # `coded` is the authoritative execution config for the coded matmul
    # device path (scheme, backend, decode layout, ...), validated at
    # construction against the scheme/backend registries -- new backends
    # registered in repro_torch.core.coded_backends become legal values with no
    # change here.  `coded_backend` survives as the legacy backend alias:
    # its None default means "follow coded.backend" (so passing coded=
    # alone is never clobbered by the alias default), a string value
    # (init kwarg or dataclasses.replace) folds into `coded`, and reads
    # always see the mirrored `coded.backend`.  Caveat: because the
    # mirror is a stored string, `dataclasses.replace(cfg, coded=...)`
    # with a DIFFERENT backend re-folds the old alias -- change backend
    # via `coded_backend=` or `with_coded(...)`, which keeps both in sync.
    coded: CodedMatmulConfig = CodedMatmulConfig()
    coded_backend: Optional[str] = None

    def __post_init__(self):
        if (self.coded_backend is not None
                and self.coded_backend != self.coded.backend):
            # the alias was written: fold it into the authoritative config,
            # which validates the name against the live backend registry
            try:
                folded = dataclasses.replace(self.coded,
                                             backend=self.coded_backend)
            except ValueError as e:
                raise ValueError(f"coded_backend: {e}") from None
            object.__setattr__(self, "coded", folded)
        object.__setattr__(self, "coded_backend", self.coded.backend)

    def with_coded(self, **kw) -> "ArchConfig":
        """Replace fields of the embedded ``CodedMatmulConfig`` (keeping the
        ``coded_backend`` alias mirror consistent)."""
        new = dataclasses.replace(self.coded, **kw)
        return dataclasses.replace(self, coded=new, coded_backend=new.backend)

    def with_opts(self, names) -> "ArchConfig":
        valid = {"fused_ce", "moe_local_dispatch", "onehot_cache",
                 "serving_layout", "seq_parallel", "remat_save_tp",
                 "moe_shardmap_combine", "coded_moe"}
        kw = {}
        for nm in names:
            if nm not in valid:
                raise ValueError(f"unknown opt {nm!r}; options {sorted(valid)}")
            kw[f"opt_{nm}"] = True
        return dataclasses.replace(self, **kw)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def group_size(self) -> int:
        """Layers per scan group (the repeating heterogeneous unit)."""
        g = 1
        if self.attn_every > 1:
            g = self.attn_every
        if self.cross_attn_every > 0:
            g = max(g, self.cross_attn_every)
        if self.moe and self.moe.every > 1:
            import math
            g = math.lcm(g, self.moe.every)
        return g

    def layer_plan(self) -> list[tuple[str, str]]:
        """(mixer, ffn) for each slot in one scan group.

        mixer: attn | cross | mamba | rwkv;  ffn: mlp | moe.
        """
        plan = []
        for s in range(self.group_size):
            if self.rwkv:
                mixer = "rwkv"
            elif self.attn_every > 1:
                # jamba-style: one attention layer per group, rest mamba
                mixer = "attn" if s == self.attn_every // 2 else "mamba"
            elif self.cross_attn_every > 0 and (s + 1) % self.cross_attn_every == 0:
                mixer = "cross"
            else:
                mixer = "attn"
            if self.moe is not None and (s % self.moe.every == self.moe.every - 1):
                ffn = "moe"
            else:
                ffn = "mlp"
            plan.append((mixer, ffn))
        return plan

    @property
    def num_groups(self) -> int:
        assert self.num_layers % self.group_size == 0, (
            f"{self.name}: num_layers {self.num_layers} % group {self.group_size}")
        return self.num_layers // self.group_size

    def params_count(self) -> int:
        """Analytic parameter count (embeddings + layers + head)."""
        d, hd = self.d_model, self.hd
        qk = self.num_heads * hd
        kv = self.num_kv_heads * hd
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        for mixer, ffn in self.layer_plan() * self.num_groups:
            if mixer in ("attn", "cross"):
                total += d * qk + 2 * d * kv + qk * d
                if mixer == "cross":
                    total += d * qk + 2 * d * kv + qk * d  # paired self-attn block
            elif mixer == "mamba":
                di = self.ssm.expand * d
                total += d * 2 * di + di * self.ssm.d_conv + di * (
                    2 * self.ssm.d_state + 2) + di * d
            elif mixer == "rwkv":
                hsz = self.rwkv_head_size
                total += 4 * d * d + d * hsz  # r,k,v,o (+gates approximated)
            if ffn == "moe":
                total += self.moe.num_experts * 3 * d * self.moe.d_ff + d * self.moe.num_experts
            else:
                n_mats = 3 if self.act == "silu" else 2
                total += n_mats * d * self.d_ff
            total += 2 * d  # norms
        if self.encoder_layers:
            total += self.encoder_layers * (2 * (d * qk + 2 * d * kv + qk * d) // 2
                                            + (3 if self.act == "silu" else 2) * d * self.d_ff
                                            + 2 * d)
        return int(total)

    def active_params_count(self) -> int:
        """Active parameters per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.params_count()
        full = self.params_count()
        moe_layers = sum(1 for _, f in self.layer_plan() if f == "moe") * self.num_groups
        per_expert = 3 * self.d_model * self.moe.d_ff
        inactive = moe_layers * (self.moe.num_experts - self.moe.top_k) * per_expert
        return int(full - inactive)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        g = self.group_size
        moe = None
        if self.moe:
            # capacity_factor = num_experts => capacity >= T * top_k: nothing
            # ever drops, so decode == forward exactly (the smoke suite checks
            # cache exactness; capacity drops are a train-time efficiency knob)
            moe = dataclasses.replace(self.moe, num_experts=min(4, self.moe.num_experts),
                                      top_k=min(2, self.moe.top_k), d_ff=64,
                                      capacity_factor=float(min(4, self.moe.num_experts)))
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=g * 2 if self.family != "encdec" else g * 2,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(2, self.num_kv_heads),
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            moe=moe,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=16 if self.encoder_layers else self.encoder_seq,
            vision_tokens=16 if self.cross_attn_every else self.vision_tokens,
            rwkv_head_size=16 if self.rwkv else self.rwkv_head_size,
            max_seq=128,
        )


ARCH_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg
