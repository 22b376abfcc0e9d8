"""GQA attention (self and cross) with RoPE, optional QKV biases and a KV
cache.

The scores and the softmax run in f32 (f64 for f64 queries) and are cast
back to the query's dtype; masked scores are ``NEG_INF`` (not -inf), as in the JAX package, so
a fully masked row stays finite.  Cross-attention (the vlm and encdec
families) attends, unmasked and without RoPE, over a memory: image tokens
or the encoder's output.

Under a ``DeviceMesh`` the projections put their head axis over "model"
where the head count divides among the model shards, and replicate it
otherwise (the reference's GQA-TP rule), with the batch over "dp"; each
rank attends over its own batch and heads (``local_map``), and the
self-attention output is placed over "dp".  Cross-attention places
nothing yet (ROADMAP queue 1, item 8b).
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.launch import meshctx
from repro_torch.launch.meshctx import maybe_shard
from repro_torch.models.layers import ParamDef, apply_rope

NEG_INF = -2.0 ** 30


def attn_defs(cfg, cross: bool = False) -> dict:
    """The projections of one attention block; ``cross`` changes nothing
    (the JAX package takes and ignores it too)."""
    d, hd = cfg.d_model, cfg.hd
    H, KV = cfg.num_heads, cfg.num_kv_heads
    defs = {
        "wq": ParamDef((d, H * hd), spec=("data", "model")),
        "wk": ParamDef((d, KV * hd), spec=("data", "model")),
        "wv": ParamDef((d, KV * hd), spec=("data", "model")),
        "wo": ParamDef((H * hd, d), spec=("model", "data")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H * hd,), init="zeros", spec=("model",))
        defs["bk"] = ParamDef((KV * hd,), init="zeros", spec=("model",))
        defs["bv"] = ParamDef((KV * hd,), init="zeros", spec=("model",))
    return defs


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the promoted dtype of the two, as JAX's einsum computes it
    (a cross-attention memory, or a cache, need not be in the weights'
    dtype)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _linear(x: torch.Tensor, p: dict, cfg, name: str) -> torch.Tensor:
    """The projection (..., heads * hd), its bias added."""
    out = _mm(x, p[f"w{name}"])
    if cfg.qkv_bias and name in ("q", "k", "v"):
        out = out + p[f"b{name}"]
    return out


def _split_heads(t: torch.Tensor, cfg) -> torch.Tensor:
    return t.reshape(*t.shape[:-1], t.shape[-1] // cfg.hd, cfg.hd)


def _project(x: torch.Tensor, p: dict, cfg, heads: int, name: str) -> torch.Tensor:
    return _split_heads(_linear(x, p, cfg, name), cfg)


def _head_axis(heads: int):
    """GQA-TP (the reference's ``_proj``): the head axis over "model" only
    where the head count divides among the model shards; else replicated
    over "model", cheaper than repartitioning K/V."""
    return "model" if heads % meshctx.axis_size("model") == 0 else None


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,T,KV,hd).  Query head h reads KV head
    h // (H // KV).  A cache of another dtype than q is promoted as JAX's
    einsum promotes it (f32 queries on a bf16 cache compute in f32)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    dt = torch.promote_types(q.dtype, k.dtype)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskrh,btkh->bkrst", qg, k)
    scores = scores.to(torch.promote_types(scores.dtype, torch.float32))
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bkrst,btkh->bskrh", probs, v)
    return out.reshape(B, S, H, hd)


def _write_cache(cache: dict, k: torch.Tensor, v: torch.Tensor, cfg) -> None:
    """Write this step's k/v into the cache at position ``length``, in
    place.  One decoded token with ``opt_onehot_cache`` takes the JAX
    package's one-hot masked form (elementwise over the whole cache); every
    other step writes the slice.  Both give the same numbers."""
    ck, cv, length = cache["k"], cache["v"], cache["length"]
    S, T = k.shape[1], ck.shape[1]
    if length + S > T:
        raise ValueError(f"the KV cache holds {T} positions; writing {S} at "
                         f"{length} would run past it")
    if getattr(cfg, "opt_onehot_cache", False) and S == 1:
        hot = (torch.arange(T, device=ck.device) == length).to(ck.dtype)
        hot = hot[None, :, None, None]
        ck.mul_(1 - hot).add_(k.to(ck.dtype) * hot)
        cv.mul_(1 - hot).add_(v.to(cv.dtype) * hot)
    else:
        ck[:, length:length + S] = k.to(ck.dtype)
        cv[:, length:length + S] = v.to(cv.dtype)


def self_attention(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor, *,
                   causal: bool = True, cache: dict | None = None) -> torch.Tensor:
    """x: (B,S,d) -> (B,S,d).  ``cache`` = dict(k, v, length) for prefill
    and decode: this step's k/v are written into ``cache["k"]``/``["v"]``
    (in place) at ``length``, and the queries attend over the whole cache,
    masked to the positions written so far."""
    B, S, _ = x.shape
    q, k, v = (maybe_shard(_linear(x, p, cfg, n), "dp", None, _head_axis(h))
               for n, h in (("q", cfg.num_heads), ("k", cfg.num_kv_heads),
                            ("v", cfg.num_kv_heads)))
    # each rank attends over its own (batch, heads) slice (``local_map``;
    # the head split, RoPE and the softmax are per head): heads over
    # "model" where both head counts divide among the model shards, so a
    # query shard reads its own K/V shard, else replicated
    both = _head_axis(cfg.num_heads) if _head_axis(cfg.num_kv_heads) else None
    qkv = ("dp", None, both)
    out = meshctx.local(functools.partial(_attend, cfg=cfg, causal=causal, cache=cache),
                        (qkv, qkv, qkv, None), (qkv,))(q, k, v, positions)
    return maybe_shard(_mm(out, p["wo"]), "dp", None, None)


def _attend(q, k, v, positions, *, cfg, causal: bool, cache: dict | None) -> torch.Tensor:
    """Projected q, k, v (B, S, heads * hd) -> the attention output
    (B, S, H * hd): heads split, RoPE, the cache written and read, the
    masked softmax."""
    B, S, _ = q.shape
    q, k, v = (_split_heads(t, cfg) for t in (q, k, v))
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None:
        _write_cache(cache, k, v, cfg)
        k, v = cache["k"], cache["v"]
        tpos = torch.arange(k.shape[1], device=q.device)
        qpos = cache["length"] + torch.arange(S, device=q.device)
        mask = (tpos[None, :] <= qpos[:, None])[None, None, None]     # (S, T)
    elif causal:
        tpos = torch.arange(S, device=q.device)
        mask = (tpos[None, :] <= tpos[:, None])[None, None, None]
    else:
        mask = None
    return _sdpa(q, k, v, mask).reshape(B, S, -1)


def cross_attention(x: torch.Tensor, memory: torch.Tensor | None, p: dict, cfg, *,
                    mem_kv: tuple | None = None):
    """x: (B,S,d) queries; memory: (B,M,d) (the encoder's output or image
    tokens) -> (out (B,S,d), (k, v)).  ``mem_kv``: the memory's k/v made
    before (a decode step reuses the prefill's); the k/v used are
    returned either way.  No mask and no RoPE.  With neither a memory nor
    its k/v it raises ``ValueError``, as the reference's einsum does."""
    q = _project(x, p, cfg, cfg.num_heads, "q")
    if mem_kv is None:
        if memory is None:
            raise ValueError("cross-attention needs a memory (the vlm family's "
                             "'vision' or the encdec family's 'frames') or its k/v")
        k = _project(memory, p, cfg, cfg.num_kv_heads, "k")
        v = _project(memory, p, cfg, cfg.num_kv_heads, "v")
    else:
        k, v = mem_kv
    out = _sdpa(q, k, v)
    B, S = x.shape[:2]
    return _mm(out.reshape(B, S, -1), p["wo"]), (k, v)
