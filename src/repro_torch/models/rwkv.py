"""The RWKV-6 "Finch" token-mixing block and its channel mix.

Per head of size hs, the recurrent state S (hs x hs) evolves as

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

with w_t = exp(-exp(decay(x_t))) a data-dependent per-channel decay made
by a low-rank MLP, and token-shift interpolation on every projection's
input.  The JAX package's arithmetic and dtypes: the decay and the scan in
f32 (in f64 where the model computes in f64), the scan's output cast to
the compute dtype, then a per-head RMS normalisation (eps 1e-6) and
``ln_out``.

The scan is a loop over time with state (B, H, hs, hs), one step a token,
as the reference's ``jax.lax.scan``; each step's k v^T (and u k v^T) is
made for all tokens at once before it, and each step reads its token's
views of those tensors.  Decode carries (last_x, last_cm,
S): the time mix's and the channel mix's last inputs and the state.

Under a ``DeviceMesh`` the block places what the reference places: the
(B, S, H, hs) heads ("dp", None, "model", None), the output ("dp", None,
None) and the channel mix's hidden ("dp", None, "model").  The heads go
over "model" only where H divides among the model shards (rwkv6-3b's 40
heads on 16 shards are replicated, as the reference's sanitizer
replicates them), and so does the state S of a decode step.  The scan runs
on each rank's own batch and heads (``meshctx.local``): no rank gathers
the heads of another.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch import meshctx
from repro_torch.launch.meshctx import maybe_shard
from repro_torch.models.layers import ParamDef, activation

DECAY_RANK = 64


def rwkv_defs(cfg) -> dict:
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    H = d // hs
    return {
        # token-shift interpolation weights for the r/k/v/g/w inputs
        "mu": ParamDef((5, d), init="small_normal", spec=(None, None)),
        "wr": ParamDef((d, d), spec=("data", "model")),
        "wk": ParamDef((d, d), spec=("data", "model")),
        "wv": ParamDef((d, d), spec=("data", "model")),
        "wg": ParamDef((d, d), spec=("data", "model")),
        "wo": ParamDef((d, d), spec=("model", "data")),
        # low-rank data-dependent decay: d -> rank -> d
        "decay_a": ParamDef((d, DECAY_RANK), init="small_normal", spec=("data", None)),
        "decay_b": ParamDef((DECAY_RANK, d), init="small_normal", spec=(None, "model")),
        "decay_base": ParamDef((d,), init="zeros", spec=("model",)),
        "u": ParamDef((H, hs), init="small_normal", spec=("model", None)),
        "ln_out": ParamDef((d,), init="ones", spec=()),
    }


def channel_mix_defs(cfg) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mu": ParamDef((2, d), init="small_normal", spec=(None, None)),
        "wk": ParamDef((d, ff), spec=("data", "model")),
        "wv": ParamDef((ff, d), spec=("model", "data")),
        "wr": ParamDef((d, d), spec=("data", None)),
    }


def _shift(x: torch.Tensor, last: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: x_{t-1}, with zeros (or ``last``) before the first
    position.  One token with ``last`` takes ``last`` as it is (its dtype
    too), as the reference does."""
    if x.shape[1] == 1:
        return torch.zeros_like(x) if last is None else last[:, None]
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, xprev: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (xprev - x) * mu


def rwkv_apply(x: torch.Tensor, p: dict, cfg, *, state: dict | None = None):
    """x: (B,S,d).  state=None (training) -> (out, None); else state =
    dict(last_x (B,d), last_cm (B,d), S (B,H,hs,hs)) -> (out, new_state),
    ``last_cm`` passed through (the channel mix replaces it)."""
    B, S, d = x.shape
    hs = cfg.rwkv_head_size
    H = d // hs
    bax, hax = meshctx.fit(B, "dp"), meshctx.fit(H, "model")

    def heads(t):  # placed flat first, and the gradient placed before the view's
        # backward: DTensor splits or merges no unevenly sharded dim
        return meshctx.grad_placed(maybe_shard(t, bax, None, hax).reshape(B, S, H, hs),
                                   bax, None, hax, None)

    xprev = _shift(x, None if state is None else state["last_x"])
    xr, xk, xv, xg, xw = (_mix(x, xprev, p["mu"][i]) for i in range(5))

    r = heads(xr @ p["wr"])
    k = heads(xk @ p["wk"])
    v = heads(xv @ p["wv"])
    g = F.silu(xg @ p["wg"])
    # data-dependent decay in (0, 1): w = exp(-exp(lora(xw) + base))
    dec = torch.tanh(xw @ p["decay_a"]) @ p["decay_b"] + p["decay_base"]
    acc = torch.promote_types(x.dtype, torch.float32)
    w = heads(torch.exp(-torch.exp(dec.to(acc))))

    u = maybe_shard(p["u"], hax, None).to(acc)
    r, k, v = r.to(acc), k.to(acc), v.to(acc)
    kv = k[..., :, None] * v[..., None, :]               # (B,S,H,hs,hs)
    ukv = u[:, :, None] * kv
    hd4, hd5 = (bax, None, hax, None), (bax, None, hax, None, None)
    scan = meshctx.local(_scan, (hd4, hd4, hd5, hd5,
                                 (bax, hax, None, None) if state is not None else None),
                         (hd4, (bax, hax, None, None)))
    o, Sst = scan(r, w, kv, ukv, None if state is None else state["S"])
    # each merge of the heads takes its gradient in the heads' placement
    o = meshctx.grad_placed(o.reshape(B, S, d), bax, None, hax).to(x.dtype)

    # per-head RMS normalisation (the reference's stand-in for group norm)
    oh = o.reshape(B, S, H, hs)
    var = oh.to(acc).square().mean(-1, keepdim=True)
    o = meshctx.grad_placed((oh * torch.rsqrt(var + 1e-6)).reshape(B, S, d), bax, None, hax)
    o = o.to(x.dtype) * p["ln_out"]
    out = maybe_shard((o * g) @ p["wo"], "dp", None, None)

    if state is None:
        return out, None
    return out, {"last_x": x[:, -1], "last_cm": state["last_cm"], "S": Sst}


def _scan(r, w, kv, ukv, Sst):
    """The recurrence over each head, a token a step, from ``Sst`` (zeros
    in the accumulation dtype where None): (o (B,S,H,hs), the last S)."""
    B, _, H, hs = r.shape
    if Sst is None:
        Sst = torch.zeros((B, H, hs, hs), dtype=r.dtype, device=r.device)
    # each token's views by one unbind a tensor: its backward stacks the
    # steps' gradients once, where indexing step t would add a zero-filled
    # tensor of the whole sequence's size a step (O(S^2) traffic)
    os = []
    for r_t, w_t, kv_t, ukv_t in zip(*(a.unbind(1) for a in (r, w, kv, ukv))):
        os.append((r_t[..., None] * (Sst + ukv_t)).sum(-2))
        Sst = w_t[..., None] * Sst + kv_t
    return torch.stack(os, 1), Sst


def channel_mix_apply(x: torch.Tensor, p: dict, cfg, *, last: torch.Tensor | None = None):
    """The RWKV channel mix (the arch's FFN): relu^2 with a receptance gate.
    Returns (out, x[:, -1] where ``last`` was given, else None)."""
    xprev = _shift(x, last)
    xk = _mix(x, xprev, p["mu"][0])
    xr = _mix(x, xprev, p["mu"][1])
    kk = maybe_shard(activation(xk @ p["wk"], "relu_sq"), "dp", None, "model")
    vv = kk @ p["wv"]
    rr = torch.sigmoid(xr @ p["wr"])
    return rr * vv, (x[:, -1] if last is not None else None)


def rwkv_init_state(cfg, batch: int, dtype: torch.dtype = torch.bfloat16,
                    device=None) -> dict:
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    H = d // hs
    return {
        "last_x": torch.zeros((batch, d), dtype=dtype, device=device),
        "last_cm": torch.zeros((batch, d), dtype=dtype, device=device),
        "S": torch.zeros((batch, H, hs, hs), dtype=torch.float32, device=device),
    }
