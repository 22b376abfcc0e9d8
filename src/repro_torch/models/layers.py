"""Shared model layers: parameter defs, norms, activations, RoPE, the MLP.

Plain functions on tensors, computing what the JAX package's layers compute
in the same dtypes: the norms reduce in f32 and cast back before the scale,
RoPE rotates halves (not pairs) in f32, and ``gelu`` is the tanh form.  The
cross-entropy functions belong to training and are not here yet (ROADMAP
queue 1, item 7).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


# ------------------------------ param defs ---------------------------------

@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: a shape and an init rule."""

    shape: tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones | small_normal

    def materialize(self, generator: torch.Generator, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
        """The JAX package's rule: a normal draw at scale 0.02 (0.006 for
        ``small_normal``), capped at 1/sqrt(fan-in), where fan-in is the
        next-to-last dim (the last for a vector), drawn in f32 from
        ``generator`` (which lives on ``device``) and then cast."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        scale = 0.02 if self.init == "normal" else 0.006
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        scale = min(scale, 1.0 / math.sqrt(max(fan_in, 1)))
        draw = torch.randn(self.shape, generator=generator, device=device,
                           dtype=torch.float32)
        return (draw * scale).to(dtype)


def tree_init(defs: dict, generator: torch.Generator, dtype: torch.dtype,
              device: torch.device) -> dict:
    """Materialize a nested dict of ``ParamDef`` into tensors, drawing the
    leaves in sorted-key order from one generator (deterministic for a
    seed and a device)."""
    return {k: (v.materialize(generator, dtype, device)
                if isinstance(v, ParamDef)
                else tree_init(v, generator, dtype, device))
            for k, v in sorted(defs.items())}


# ------------------------------- norms -------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale


def norm(x: torch.Tensor, scale: torch.Tensor, kind: str) -> torch.Tensor:
    return rmsnorm(x, scale) if kind == "rmsnorm" else layernorm(x, scale)


# ----------------------------- activations ---------------------------------

def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form
    if kind == "relu_sq":
        return F.relu(x).square()
    raise ValueError(kind)


# -------------------------------- RoPE --------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Rotates
    the first half of each head against the second."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10_000.0, device=device), dim / d)
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


# --------------------------------- MLP --------------------------------------

def mlp_apply(x: torch.Tensor, p: dict, act: str, bias: bool) -> torch.Tensor:
    """SwiGLU when act == 'silu' (``b_up`` unused, as in the JAX package),
    plain two-matrix MLP otherwise."""
    if act == "silu":
        h = activation(x @ p["w_gate"], act) * (x @ p["w_up"])
    else:
        h = x @ p["w_up"]
        if bias:
            h = h + p["b_up"]
        h = activation(h, act)
    out = h @ p["w_down"]
    if bias:
        out = out + p["b_down"]
    return out


def mlp_defs(d: int, ff: int, act: str, bias: bool) -> dict:
    defs = {"w_up": ParamDef((d, ff)), "w_down": ParamDef((ff, d))}
    if act == "silu":
        defs["w_gate"] = ParamDef((d, ff))
    if bias:
        defs["b_up"] = ParamDef((ff,), init="zeros")
        defs["b_down"] = ParamDef((d,), init="zeros")
    return defs
