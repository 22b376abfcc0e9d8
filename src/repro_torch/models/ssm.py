"""The Mamba selective SSM block (the jamba hybrid's mixer).

Mamba-1 as the JAX package writes it: an in-projection to (x, z) of width
d_inner, a causal depthwise conv, data-dependent (dt, B, C), a diagonal
state-space scan and a gated out-projection.  One path serves training,
prefill and decode: the conv takes its left context from the carried conv
state and the scan starts from the carried h; with ``state=None``
(training) both start at zero and no state is returned.

The scan is a loop over time in f32 (f64 where the model computes in
f64), one step a token, as the reference's
``jax.lax.scan``: each step's decay ``exp(dt A)`` and input ``dt x B`` are
made for all tokens at once before it (the same elementwise arithmetic),
so a step is the state's update and its read-out by C.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamDef


def _dims(cfg):
    di = cfg.ssm.expand * cfg.d_model
    dt_rank = max(1, cfg.d_model // 16)
    return di, dt_rank, cfg.ssm.d_state, cfg.ssm.d_conv


def mamba_defs(cfg) -> dict:
    d = cfg.d_model
    di, dt_rank, ds, dc = _dims(cfg)
    return {
        "in_proj": ParamDef((d, 2 * di), spec=("data", "model")),
        "conv_w": ParamDef((dc, di), spec=(None, "model")),
        "conv_b": ParamDef((di,), init="zeros", spec=("model",)),
        "x_proj": ParamDef((di, dt_rank + 2 * ds), spec=("model", None)),
        "dt_proj": ParamDef((dt_rank, di), spec=(None, "model")),
        "dt_bias": ParamDef((di,), init="zeros", spec=("model",)),
        "A_log": ParamDef((di, ds), init="zeros", spec=("model", None)),
        "D": ParamDef((di,), init="ones", spec=("model",)),
        "out_proj": ParamDef((di, d), spec=("model", "data")),
    }


def mamba_apply(x: torch.Tensor, p: dict, cfg, *, state=None):
    """x: (B, S, d) -> (out (B, S, d), new_state | None).

    state: None (training) or (conv_state (B, dc-1, di), h (B, di, ds)).
    The new state is (the last dc-1 conv inputs in the compute dtype, h in
    f32 -- f64 where the model computes in f64), whatever the dtype of the
    state given.
    """
    B, S, _ = x.shape
    di, dt_rank, ds, dc = _dims(cfg)

    xin, z = (x @ p["in_proj"]).split(di, dim=-1)      # (B,S,di) each
    acc = torch.promote_types(x.dtype, torch.float32)
    A = -torch.exp(p["A_log"].to(acc))                   # (di, ds)

    if state is None:
        conv_state = torch.zeros((B, dc - 1, di), dtype=x.dtype, device=x.device)
        h = torch.zeros((B, di, ds), dtype=acc, device=x.device)
    else:
        conv_state, h = state

    # causal depthwise conv with carried left context, summed in tap order
    xpad = torch.cat([conv_state.to(xin.dtype), xin], dim=1)
    xc = xpad[:, 0:S] * p["conv_w"][0]
    for i in range(1, dc):
        xc = xc + xpad[:, i:i + S] * p["conv_w"][i]
    xc = F.silu(xc + p["conv_b"])                        # (B,S,di)

    dt, Bm, Cm = (xc @ p["x_proj"]).split([dt_rank, ds, ds], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])

    dA = torch.exp(dt[..., None].to(acc) * A)            # (B,S,di,ds)
    dBx = (dt * xc)[..., None].to(acc) * Bm[:, :, None, :].to(acc)
    C = Cm.to(acc)
    ys = []  # each token's views by one unbind a tensor (one stack in the backward)
    for dA_t, dBx_t, C_t in zip(dA.unbind(1), dBx.unbind(1), C.unbind(1)):
        h = h * dA_t + dBx_t
        ys.append(torch.einsum("bds,bs->bd", h, C_t))
    y = torch.stack(ys, 1).to(x.dtype)                   # (B,S,di)
    y = y + xc * p["D"]
    out = (F.silu(z) * y) @ p["out_proj"]

    if state is None:
        return out, None
    new_conv = xpad[:, -(dc - 1):] if dc > 1 else conv_state
    return out, (new_conv, h)


def mamba_init_state(cfg, batch: int, dtype: torch.dtype = torch.bfloat16,
                     device=None) -> list:
    """[conv_state (batch, dc-1, di) in ``dtype``, h (batch, di, ds) f32]: a
    list, so a cache can replace its leaves."""
    di, _, ds, dc = _dims(cfg)
    return [torch.zeros((batch, dc - 1, di), dtype=dtype, device=device),
            torch.zeros((batch, di, ds), dtype=torch.float32, device=device)]
