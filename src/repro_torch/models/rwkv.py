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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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

    xprev = _shift(x, None if state is None else state["last_x"])
    xr, xk, xv, xg, xw = (_mix(x, xprev, p["mu"][i]) for i in range(5))

    r = (xr @ p["wr"]).reshape(B, S, H, hs)
    k = (xk @ p["wk"]).reshape(B, S, H, hs)
    v = (xv @ p["wv"]).reshape(B, S, H, hs)
    g = F.silu(xg @ p["wg"])
    # data-dependent decay in (0, 1): w = exp(-exp(lora(xw) + base))
    dec = torch.tanh(xw @ p["decay_a"]) @ p["decay_b"] + p["decay_base"]
    acc = torch.promote_types(x.dtype, torch.float32)
    w = torch.exp(-torch.exp(dec.to(acc))).reshape(B, S, H, hs)

    u = p["u"].to(acc)
    r, k, v = r.to(acc), k.to(acc), v.to(acc)
    kv = k[..., :, None] * v[..., None, :]               # (B,S,H,hs,hs)
    ukv = u[:, :, None] * kv
    Sst = (torch.zeros((B, H, hs, hs), dtype=acc, device=x.device)
           if state is None else state["S"])
    # each token's views by one unbind a tensor: its backward stacks the
    # steps' gradients once, where indexing step t would add a zero-filled
    # tensor of the whole sequence's size a step (O(S^2) traffic)
    os = []
    for r_t, w_t, kv_t, ukv_t in zip(*(a.unbind(1) for a in (r, w, kv, ukv))):
        os.append((r_t[..., None] * (Sst + ukv_t)).sum(-2))
        Sst = w_t[..., None] * Sst + kv_t
    o = torch.stack(os, 1).reshape(B, S, d).to(x.dtype)

    # per-head RMS normalisation (the reference's stand-in for group norm)
    oh = o.reshape(B, S, H, hs)
    var = oh.to(acc).square().mean(-1, keepdim=True)
    o = (oh * torch.rsqrt(var + 1e-6)).reshape(B, S, d)
    o = o.to(x.dtype) * p["ln_out"]
    out = (o * g) @ p["wo"]

    if state is None:
        return out, None
    return out, {"last_x": x[:, -1], "last_cm": state["last_cm"], "S": Sst}


def channel_mix_apply(x: torch.Tensor, p: dict, cfg, *, last: torch.Tensor | None = None):
    """The RWKV channel mix (the arch's FFN): relu^2 with a receptance gate.
    Returns (out, x[:, -1] where ``last`` was given, else None)."""
    xprev = _shift(x, last)
    xk = _mix(x, xprev, p["mu"][0])
    xr = _mix(x, xprev, p["mu"][1])
    vv = activation(xk @ p["wk"], "relu_sq") @ p["wv"]
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
