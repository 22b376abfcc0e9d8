"""GQA attention (self and cross) with RoPE, optional QKV biases and a KV
cache.

The scores and the softmax run in f32 (f64 for f64 queries) and are cast
back to the query's dtype; masked scores are ``NEG_INF`` (not -inf), as in the JAX package, so
a fully masked row stays finite.  Cross-attention (the vlm and encdec
families) attends, unmasked and without RoPE, over a memory: image tokens
or the encoder's output.

Under a ``DeviceMesh`` the projections put their head axis over "model"
where the head count divides among the model shards, and replicate it
otherwise (the reference's GQA-TP rule), with the batch over "dp" where
it divides among the dp shards (else replicated over them); each
rank attends over its own batch and heads (``local_map``), and the output
is placed ("dp", None, None), for self- and cross-attention alike.

A step with a cache attends over it as the cache is placed
(``Model.cache_specs``): its sequence over "model", each model shard
holding T / tp positions (flash-decode).  Each shard attends with all the
query heads over its own positions, keeping per query and head the
running max, the sum of exponentials and their sum against v; one max
and one sum all-reduce over "model" then give the softmax over all T.
The step's new k/v are written only by the shard that holds their
positions, and the mask is in global positions.  Where the cache's
sequence is not split (it does not divide, or no "model" axis), the same
code runs with no combine.  No rank gathers the cache.  A prefill (a step
into an empty cache) attends over its own k/v with the heads over
"model", as training does, and only writes the cache's shards.
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


def _write_cache(ck: torch.Tensor, cv: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: int, cfg, T: int, offset: int = 0) -> None:
    """Write this step's k/v into the cache at position ``length``, in
    place: ``ck``/``cv`` hold the cache's positions ``offset`` ..
    ``offset + ck.shape[1]`` of ``T`` (a model shard's slice, or all of
    it), and only the positions written that fall among them are stored.
    One decoded token with ``opt_onehot_cache`` takes the JAX package's
    one-hot masked form (elementwise over the whole cache, or shard);
    every other step writes the slice.  Both give the same numbers."""
    S, Tl = k.shape[1], ck.shape[1]
    if length + S > T:
        raise ValueError(f"the KV cache holds {T} positions; writing {S} at "
                         f"{length} would run past it")
    if getattr(cfg, "opt_onehot_cache", False) and S == 1:
        hot = (offset + torch.arange(Tl, device=ck.device) == length).to(ck.dtype)
        hot = hot[None, :, None, None]
        ck.mul_(1 - hot).add_(k.to(ck.dtype) * hot)
        cv.mul_(1 - hot).add_(v.to(cv.dtype) * hot)
        return
    lo, hi = max(length, offset), min(length + S, offset + Tl)
    if lo < hi:
        ck[:, lo - offset:hi - offset] = k[:, lo - length:hi - length].to(ck.dtype)
        cv[:, lo - offset:hi - offset] = v[:, lo - length:hi - length].to(cv.dtype)


def self_attention(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor, *,
                   causal: bool = True, cache: dict | None = None) -> torch.Tensor:
    """x: (B,S,d) -> (B,S,d).  ``cache`` = dict(k, v, length) for prefill
    and decode: this step's k/v are written into ``cache["k"]``/``["v"]``
    (in place) at ``length``, and the queries attend over the whole cache,
    masked to the positions written so far."""
    B, S, _ = x.shape
    if cache is not None:
        return _cached_attention(x, p, cfg, positions, cache)
    q, k, v = (maybe_shard(_linear(x, p, cfg, n), "dp", None, _head_axis(h))
               for n, h in (("q", cfg.num_heads), ("k", cfg.num_kv_heads),
                            ("v", cfg.num_kv_heads)))
    # each rank attends over its own (batch, heads) slice (``local_map``;
    # the head split, RoPE and the softmax are per head): heads over
    # "model" where both head counts divide among the model shards, so a
    # query shard reads its own K/V shard, else replicated
    both = _head_axis(cfg.num_heads) if _head_axis(cfg.num_kv_heads) else None
    qkv = (meshctx.fit(B, "dp"), None, both)
    out = meshctx.local(functools.partial(_attend, cfg=cfg, causal=causal),
                        (qkv, qkv, qkv, None), (qkv,))(q, k, v, positions)
    return maybe_shard(_mm(out, p["wo"]), "dp", None, None)


def _attend(q, k, v, positions, *, cfg, causal: bool) -> torch.Tensor:
    """Projected q, k, v (B, S, heads * hd) -> the attention output
    (B, S, H * hd): heads split, RoPE, the masked softmax."""
    B, S, _ = q.shape
    q, k, v = (_split_heads(t, cfg) for t in (q, k, v))
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    mask = None
    if causal:
        tpos = torch.arange(S, device=q.device)
        mask = (tpos[None, :] <= tpos[:, None])[None, None, None]
    return _sdpa(q, k, v, mask).reshape(B, S, -1)


def _cache_axes(ck) -> tuple:
    """The placement tuple of a (B, T, KV, hd) cache leaf: its batch over
    "dp" and its sequence over "model" where they divide (as
    ``Model.init_cache`` placed it); () with no ``DeviceMesh``."""
    if meshctx.device_mesh() is None:
        return ()
    return meshctx.fitted(tuple(ck.shape), meshctx.spec("dp", "model", None, None))


def _over_cache(q, ck, cv, *, k=None, v=None, positions=None, length: int = 0, cfg,
                mask: bool = True) -> torch.Tensor:
    """Queries (B, S, H * hd) over a cache (B, T, KV, hd) as it is placed
    (module docstring): with ``k``/``v`` (B, S, KV * hd) this step's keys
    and values, roped with the queries at ``positions`` and written at
    ``length`` first, and ``mask`` the causal one in global positions.
    Returns (B, S, H * hd), placed (batch, None, None)."""
    ax = _cache_axes(ck)
    bax, tax = (ax[0], ax[1]) if ax else (None, None)
    group = meshctx.device_mesh().get_group("model") if tax is not None else None
    fn = functools.partial(_attend_shard, cfg=cfg, length=length, T=ck.shape[1],
                           offset=_shard_offset(ck), group=group, mask=mask)
    rep = (bax, None, None)
    new = (rep, rep) if k is not None else (None, None)
    return meshctx.local(fn, (rep, ax, ax, *new, None), (rep,))(q, ck, cv, k, v, positions)


def _attend_shard(q, ck, cv, k, v, positions, *, cfg, length: int, T: int, offset: int,
                  group, mask: bool) -> torch.Tensor:
    """``_over_cache`` on one rank: its batch, all heads, its positions
    ``offset`` .. ``offset + ck.shape[1]`` of the cache's ``T``; ``group``
    the "model" group the partial softmaxes combine over (None: this rank
    holds every position)."""
    B, S, _ = q.shape
    q = _split_heads(q, cfg)
    if k is not None:
        k, v = _split_heads(k, cfg), _split_heads(v, cfg)
        if cfg.use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        _write_cache(ck, cv, k, v, length, cfg, T, offset)
    m = None
    if mask:
        tpos = offset + torch.arange(ck.shape[1], device=q.device)
        qpos = length + torch.arange(S, device=q.device)
        m = (tpos[None, :] <= qpos[:, None])[None, None, None]       # (S, T local)
    if group is None:
        return _sdpa(q, ck, cv, m).reshape(B, S, -1)
    return _sdpa_combined(q, ck, cv, m, group).reshape(B, S, -1)


def _sdpa_combined(q, k, v, mask, group) -> torch.Tensor:
    """``_sdpa`` over keys split among the ranks of ``group``: this rank's
    (max, sum of exponentials, their sum against v) per query and head,
    rescaled to the group's max (one max all-reduce) and summed (one sum
    all-reduce), in f32 (f64 for f64 queries)."""
    from torch.distributed import _functional_collectives as funcol

    B, S, H, hd = q.shape
    KV = k.shape[2]
    dt = torch.promote_types(q.dtype, k.dtype)
    acc = torch.promote_types(dt, torch.float32)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskrh,btkh->bkrst", qg, k).to(acc) / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    mx = scores.amax(-1, keepdim=True)                                  # (B,KV,r,S,1)
    top = funcol.all_reduce(mx, "max", group)
    e = torch.exp(scores - top)
    total = e.sum(-1)                                                   # (B,KV,r,S)
    part = torch.einsum("bkrst,btkh->bkrsh", e.to(dt), v).to(acc)
    both = torch.cat([part, total[..., None]], dim=-1)
    both = funcol.all_reduce(both, "sum", group)
    out = (both[..., :hd] / both[..., hd:]).to(dt)                      # (B,KV,r,S,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def _cached_attention(x, p, cfg, positions, cache: dict) -> torch.Tensor:
    """Self-attention of a prefill or decode step: this step's k/v written
    into ``cache`` (dict(k, v, length)) in place, the queries over the
    whole cache masked to the positions written so far.  Under a
    ``DeviceMesh`` a step into an empty cache (a prefill) attends over its
    own k/v with the heads over "model", as training does (the cache's
    masked positions add exact zeros), and only writes the cache: no
    partial softmax of every query to combine."""
    ck = cache["k"]
    if meshctx.device_mesh() is not None and cache["length"] == 0:
        return _prefill_attention(x, p, cfg, positions, cache)
    bax = _cache_axes(ck)[0] if meshctx.device_mesh() is not None else None
    q, k, v = (maybe_shard(_linear(x, p, cfg, n), bax, None, None) for n in ("q", "k", "v"))
    out = _over_cache(q, ck, cache["v"], k=k, v=v, positions=positions,
                      length=cache["length"], cfg=cfg)
    return maybe_shard(_mm(out, p["wo"]), "dp", None, None)


def _prefill_attention(x, p, cfg, positions, cache: dict) -> torch.Tensor:
    """``_cached_attention`` of a step into an empty placed cache."""
    bax = meshctx.fit(x.shape[0], "dp")
    q, k, v = (maybe_shard(_linear(x, p, cfg, n), bax, None, _head_axis(h))
               for n, h in (("q", cfg.num_heads), ("k", cfg.num_kv_heads),
                            ("v", cfg.num_kv_heads)))
    both = _head_axis(cfg.num_heads) if _head_axis(cfg.num_kv_heads) else None
    qkv = (bax, None, both)
    out = meshctx.local(functools.partial(_attend, cfg=cfg, causal=True),
                        (qkv, qkv, qkv, None), (qkv,))(q, k, v, positions)
    ck, cv = cache["k"], cache["v"]
    ax = _cache_axes(ck)
    rep = (ax[0], None, None)
    k = meshctx.local(functools.partial(_roped, cfg=cfg), (qkv, None), (qkv,))(k, positions)
    meshctx.local(functools.partial(_write_shard, cfg=cfg, T=ck.shape[1],
                                    offset=_shard_offset(ck)),
                  (ax, ax, rep, rep), (ax,))(ck, cv, k, v)
    return maybe_shard(_mm(out, p["wo"]), "dp", None, None)


def _roped(k, positions, *, cfg) -> torch.Tensor:
    """Projected keys (B, S, KV * hd) with RoPE at ``positions`` (where the
    model uses it)."""
    if not cfg.use_rope:
        return k
    B, S, _ = k.shape
    return apply_rope(_split_heads(k, cfg), positions, cfg.rope_theta).reshape(B, S, -1)


def _write_shard(ck, cv, k, v, *, cfg, T: int, offset: int) -> torch.Tensor:
    """This step's roped k and v (B, S, KV * hd) written from position 0
    into a rank's cache positions ``offset`` .. ``offset + ck.shape[1]``;
    returns the cache's k (written in place)."""
    _write_cache(ck, cv, _split_heads(k, cfg), _split_heads(v, cfg), 0, cfg, T, offset)
    return ck


def _shard_offset(ck) -> int:
    """The first cache position this rank holds: its "model" coordinate
    times T / tp where the sequence is split, else 0."""
    ax = _cache_axes(ck)
    if not ax or ax[1] is None:
        return 0
    return meshctx.device_mesh().get_local_rank("model") * (ck.shape[1]
                                                           // meshctx.axis_size("model"))


def cross_attention(x: torch.Tensor, memory: torch.Tensor | None, p: dict, cfg, *,
                    mem_kv: tuple | None = None):
    """x: (B,S,d) queries; memory: (B,M,d) (the encoder's output or image
    tokens) -> (out (B,S,d), (k, v)).  ``mem_kv``: the memory's k/v made
    before (a decode step reuses the prefill's); the k/v used are
    returned either way.  No mask and no RoPE.  With neither a memory nor
    its k/v it raises ``ValueError``, as the reference's einsum does.

    Under a ``DeviceMesh`` q, k and v follow ``_head_axis`` as
    self-attention's do; k/v from a cache attend as the cache is placed
    (its memory axis over "model": the combine of the module docstring)."""
    B, S = x.shape[:2]
    if mem_kv is not None:
        ck, cv = mem_kv
        bax = _cache_axes(ck)[0] if meshctx.device_mesh() is not None else None
        q = maybe_shard(_linear(x, p, cfg, "q"), bax, None, None)
        out = _over_cache(q, ck, cv, cfg=cfg, mask=False)
        return maybe_shard(_mm(out, p["wo"]), "dp", None, None), (ck, cv)
    if memory is None:
        raise ValueError("cross-attention needs a memory (the vlm family's "
                         "'vision' or the encdec family's 'frames') or its k/v")
    q, k, v = (maybe_shard(_linear(t, p, cfg, n), "dp", None, _head_axis(h))
               for t, n, h in ((x, "q", cfg.num_heads), (memory, "k", cfg.num_kv_heads),
                               (memory, "v", cfg.num_kv_heads)))
    both = _head_axis(cfg.num_heads) if _head_axis(cfg.num_kv_heads) else None
    qkv = (meshctx.fit(B, "dp"), None, both)
    out = meshctx.local(functools.partial(_attend_memory, cfg=cfg),
                        (qkv, qkv, qkv), (qkv,))(q, k, v)
    k, v = _split_heads(k, cfg), _split_heads(v, cfg)
    return maybe_shard(_mm(out, p["wo"]), "dp", None, None), (k, v)


def _attend_memory(q, k, v, *, cfg) -> torch.Tensor:
    """Projected q (B, S, H * hd) over the memory's k, v (B, M, KV * hd),
    unmasked -> (B, S, H * hd)."""
    B, S, _ = q.shape
    return _sdpa(*(_split_heads(t, cfg) for t in (q, k, v))).reshape(B, S, -1)
