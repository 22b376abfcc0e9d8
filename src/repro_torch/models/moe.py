"""Mixture-of-Experts with sort-based capacity dispatch, and the coded
expert FFN.

Tokens are routed top-k, sorted by expert id, packed into an
(E, capacity, d) buffer and run through batched expert matmuls; tokens past
an expert's capacity drop, exactly as in the JAX package: its ``top_k``
puts the lower index first among equal probabilities and its ``argsort``
is stable, so both are taken in those forms here.

The paper's code over the EXPERT axis (``opt_coded_moe``): the E
per-expert products of one FFN matmul are the mn unknowns (m = E, n = 1),
encoded into N = ``coded_moe_workers`` weighted combinations -- one per
worker -- and decoded linearly with D = pinv(M).  Any full-rank survivor
set reconstructs every expert's product.  The code comes from the port's
scheme registry (``repro_torch.coded.plan``), designed once per
(scheme, E, N, seed).

On one card there is no mesh: the dp-chunk-local dispatch
(``opt_moe_local_dispatch``) routes one chunk of all T tokens, and its
combine is the plain gather and scatter-add.  The combine over a mesh
(``opt_moe_shardmap_combine``) waits for the port's device mesh (ROADMAP
queue 1, item 8).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import numpy as np
import torch

from repro_torch.models.layers import ParamDef, activation


def moe_defs(cfg) -> dict:
    d = cfg.d_model
    E, ff = cfg.moe.num_experts, cfg.moe.d_ff
    return {
        "router": ParamDef((d, E), init="small_normal", spec=("data", None)),
        "w_gate": ParamDef((E, d, ff), spec=("model", "data", None)),
        "w_up": ParamDef((E, d, ff), spec=("model", "data", None)),
        "w_down": ParamDef((E, ff, d), spec=("model", None, "data")),
    }


# ---------------------------- coded expert FFN ------------------------------

_CODED_D: contextvars.ContextVar = contextvars.ContextVar("coded_moe_D", default=None)


@contextlib.contextmanager
def coded_moe_decode(D: torch.Tensor):
    """Override the decode matrix the coded expert FFNs use.

    ``D`` is an (E, N) tensor on the model's device -- typically
    ``coded_moe_decode_matrix(cfg, survivors)`` moved there: the serving
    engine re-binds it for the survivors without re-planning (dead workers
    are zero columns, so its shape never changes).  Without the context
    the full-survivor decode is used.
    """
    token = _CODED_D.set(D)
    try:
        yield
    finally:
        _CODED_D.reset(token)


def coded_moe_num_workers(cfg) -> int:
    """N for the expert code: ``coded_moe_workers`` or E + 2."""
    n = int(getattr(cfg, "coded_moe_workers", 0) or 0)
    return n if n > 0 else cfg.moe.num_experts + 2


@functools.lru_cache(maxsize=32)
def _coded_moe_op(scheme: str, E: int, N: int, seed: int = 0):
    """The cached CodedOp designing the (m=E, n=1) expert code."""
    from repro_torch.coded import CodedMatmulConfig, plan

    return plan(CodedMatmulConfig(scheme=scheme), m=E, n=1, num_workers=N,
                seed=seed)


@functools.lru_cache(maxsize=32)
def _coded_moe_mats(scheme: str, E: int, N: int, device: torch.device):
    """The expert code's encode (N, E) and full-survivor decode (E, N), as
    f32 tensors on ``device`` (moved there once, not per product)."""
    op = _coded_moe_op(scheme, E, N)
    enc = np.asarray(op.base_plan.coefficient_matrix(), dtype=np.float32)
    dec = np.asarray(op.base_plan.decode, dtype=np.float32)
    return (torch.as_tensor(enc, device=device),
            torch.as_tensor(dec, device=device))


def coded_moe_decode_matrix(cfg, survivors=None) -> np.ndarray:
    """(E, N) f32 decode matrix for the expert code, survivor-rebound.

    ``survivors``: optional (N,) liveness mask; dead workers become zero
    columns, so the matrix shape never changes.  Raises ``DecodingError``
    on the host when the survivors lose rank, before any step runs with a
    bad decode.
    """
    op = _coded_moe_op(cfg.coded.scheme, cfg.moe.num_experts,
                       coded_moe_num_workers(cfg))
    if survivors is not None:
        op = op.with_survivors(np.asarray(survivors, dtype=bool))
    return np.asarray(op.plan_.decode, dtype=np.float32)


def _coded_expert_mm(x_e: torch.Tensor, W: torch.Tensor, cfg) -> torch.Tensor:
    """One expert-batched matmul (E, C, a) @ (E, a, b) through the code:
    encode N worker combinations of the E products, decode back to the E
    products with the current decode matrix."""
    enc, dec_full = _coded_moe_mats(cfg.coded.scheme, cfg.moe.num_experts,
                                    coded_moe_num_workers(cfg), x_e.device)
    D = _CODED_D.get()
    D = dec_full if D is None else D.to(torch.float32)
    prod = torch.matmul(x_e, W).float()                       # (E, C, F)
    y = torch.einsum("ke,ecf->kcf", enc, prod)                # worker outputs
    return torch.einsum("ek,kcf->ecf", D, y).to(x_e.dtype)


# ------------------------------- dispatch -----------------------------------

def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest, the lower index first among equal
    values (a stable descending sort)."""
    ids = torch.argsort(probs, dim=-1, descending=True, stable=True)[..., :k]
    return probs.gather(-1, ids), ids


def _moe(x: torch.Tensor, p: dict, cfg, coded: bool):
    B, S, d = x.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    T = B * S
    xt = x.reshape(T, d)

    logits = (xt @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _top_k(probs, k)                  # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # aux load-balance loss (Switch-style): E * sum_e f_e * p_e
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(expert_ids[:, 0], E).float().mean(0)
    aux = E * (me * ce).sum()

    capacity = int(max(1, (T * k * cfg.moe.capacity_factor) // E))

    flat_expert = expert_ids.reshape(-1)                      # (T*k,)
    flat_gate = gate_vals.reshape(-1).to(x.dtype)
    flat_token = torch.arange(T, device=x.device).repeat_interleave(k)

    order = torch.argsort(flat_expert, stable=True)
    se, st, sg = flat_expert[order], flat_token[order], flat_gate[order]
    # position within expert: index minus the start of its expert's segment
    starts = torch.searchsorted(se, torch.arange(E, device=x.device))
    pos = torch.arange(T * k, device=x.device) - starts[se]
    keep = pos < capacity
    pos = torch.where(keep, pos, 0)
    sg = torch.where(keep, sg, 0)

    buf = torch.zeros((E, capacity, d), dtype=x.dtype, device=x.device)
    buf.index_put_((se, pos), torch.where(keep[:, None], xt[st], 0),
                   accumulate=True)

    if coded:
        h = activation(_coded_expert_mm(buf, p["w_gate"], cfg), "silu")
        h = h * _coded_expert_mm(buf, p["w_up"], cfg)
        out_buf = _coded_expert_mm(h, p["w_down"], cfg)
    else:
        h = activation(torch.matmul(buf, p["w_gate"]), "silu")
        h = h * torch.matmul(buf, p["w_up"])
        out_buf = torch.matmul(h, p["w_down"])

    # unpack: gather each (token, choice) result, weighted-sum into tokens
    contrib = out_buf[se, pos] * sg[:, None]                  # (T*k, d)
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    out.index_put_((st,), contrib, accumulate=True)
    return out.reshape(B, S, d), aux


def moe_apply(x: torch.Tensor, p: dict, cfg):
    """x: (B, S, d) -> ((B, S, d), aux load-balance loss).

    ``opt_moe_local_dispatch`` is looked at first, as in the JAX package
    (its ``moe_apply`` returns ``moe_apply_local`` before it reads
    ``opt_coded_moe``), so local dispatch runs uncoded even with the code
    on.  The port keeps that departure of the reference."""
    if getattr(cfg, "opt_moe_local_dispatch", False):
        return moe_apply_local(x, p, cfg)
    return _moe(x, p, cfg, coded=getattr(cfg, "opt_coded_moe", False))


def moe_apply_local(x: torch.Tensor, p: dict, cfg):
    """The dp-chunk-local dispatch on one card: one dp chunk (no mesh), so
    the route, pack and combine are ``moe_apply``'s, uncoded."""
    return _moe(x, p, cfg, coded=False)
