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

Under a ``DeviceMesh`` (``launch.meshctx``) the experts are sharded over
"model" (expert parallel), as are the coded workers' outputs.  The global
dispatch routes the tokens replicated over the mesh (where the reference's
GSPMD replicates the sort and scatter); the dp-chunk-local dispatch
(``opt_moe_local_dispatch``) cuts the flat tokens into one chunk per dp
shard (``_dp_chunks``: fewer where the tokens do not divide so) and each
rank routes and packs its own, in ``local_map``, whether or not the
batch divides among the dp shards.  Its combine gathers the experts'
rows back to the tokens, or with ``opt_moe_shardmap_combine`` the
reference's ``shard_map``: each rank gathers only its own experts' rows
into an f32 partial and one bf16 ``all_reduce`` over "model" sums them.
With no mesh and one chunk every call here is the one-card path.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import numpy as np
import torch

from repro_torch.launch import meshctx
from repro_torch.launch.meshctx import local, maybe_shard
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
    # (E, C, F), each rank's experts whole: the encode mixes the experts,
    # and DTensor's einsum cannot flatten (C, F) with F sharded
    prod = maybe_shard(torch.matmul(x_e, W).float(), "model", None, None)
    y = torch.einsum("ke,ecf->kcf", enc, prod)                # worker outputs
    y = maybe_shard(y, "model", None, None)                   # over the model shards
    return torch.einsum("ek,kcf->ecf", D, y).to(x_e.dtype)


# ------------------------------- dispatch -----------------------------------

def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest, the lower index first among equal
    values (a stable descending sort)."""
    ids = torch.argsort(probs, dim=-1, descending=True, stable=True)[..., :k]
    return probs.gather(-1, ids), ids


def _route(xt: torch.Tensor, router: torch.Tensor, E: int, k: int, capacity: int):
    """One chunk's route and pack: xt (T, d) -> buf (E, capacity, d), the
    unpack indices se, st, pos and gates sg (T*k,), the router's probs
    (T, E) and each token's first expert one-hot (T, E), f32."""
    T, d = xt.shape
    logits = (xt @ router).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _top_k(probs, k)                  # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    first = torch.nn.functional.one_hot(expert_ids[:, 0], E).float()

    flat_expert = expert_ids.reshape(-1)                      # (T*k,)
    flat_gate = gate_vals.reshape(-1).to(xt.dtype)
    flat_token = torch.arange(T, device=xt.device).repeat_interleave(k)

    order = torch.argsort(flat_expert, stable=True)
    se, st, sg = flat_expert[order], flat_token[order], flat_gate[order]
    # position within expert: index minus the start of its expert's segment
    starts = torch.searchsorted(se, torch.arange(E, device=xt.device))
    pos = torch.arange(T * k, device=xt.device) - starts[se]
    keep = pos < capacity
    pos = torch.where(keep, pos, 0)
    sg = torch.where(keep, sg, 0)

    buf = torch.zeros((E, capacity, d), dtype=xt.dtype, device=xt.device)
    buf.index_put_((se, pos), torch.where(keep[:, None], xt[st], 0), accumulate=True)
    return buf, se, st, pos, sg, probs, first


def _unpack(out_buf, se, st, pos, sg, T: int) -> torch.Tensor:
    """One chunk's combine: each (token, choice) row of ``out_buf``
    weighted by its gate and summed into its token, (T, d)."""
    contrib = out_buf[se, pos] * sg[:, None]                  # (T*k, d)
    out = torch.zeros((T, out_buf.shape[-1]), dtype=out_buf.dtype, device=out_buf.device)
    out.index_put_((st,), contrib, accumulate=True)
    return out


def _ffn(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    h = activation(torch.matmul(buf, w_gate), "silu")
    h = h * torch.matmul(buf, w_up)
    return torch.matmul(h, w_down)


def _experts(buf: torch.Tensor, p: dict, cfg, coded: bool, lead: tuple) -> torch.Tensor:
    """The expert FFN on the packed buffer (..., E, C, d), placed over
    ``lead`` + ("model", None, None).  Uncoded, each rank runs its own
    experts on its own buffer rows (``local``), their weights gathered
    over "data" (FSDP); a weight's gradient then sums over the dp shards
    where the buffer is split over them.  The coded products mix every
    expert, so they run on the DTensors."""
    if coded:
        h = activation(_coded_expert_mm(buf, p["w_gate"], cfg), "silu")
        h = h * _coded_expert_mm(buf, p["w_up"], cfg)
        h = maybe_shard(h, *lead, "model", None, None)
        out_buf = _coded_expert_mm(h, p["w_down"], cfg)
    else:
        ex, w = lead + ("model", None, None), ("model", None, None)
        summed = {i: ("pod", "data") for i in (1, 2, 3)} if any(lead) else None
        out_buf = local(_ffn, (ex, w, w, w), (ex,), grad_partial=summed)(
            buf, p["w_gate"], p["w_up"], p["w_down"])
    return maybe_shard(out_buf, *lead, "model", None, None)


def _aux(probs: torch.Tensor, first: torch.Tensor, E: int) -> torch.Tensor:
    """The Switch-style load-balance loss E * sum_e f_e * p_e over every
    token (the chunk dims leading)."""
    dims = tuple(range(probs.dim() - 1))
    return E * (probs.mean(dims) * first.mean(dims)).sum()


def _moe(x: torch.Tensor, p: dict, cfg, coded: bool):
    """The global dispatch: every token routed at once.  Under a mesh the
    route and the combine run on tokens replicated over it, as the
    reference's GSPMD replicates its global argsort and scatter."""
    B, S, d = x.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    T = B * S
    capacity = int(max(1, (T * k * cfg.moe.capacity_factor) // E))
    rep = ()
    route = local(functools.partial(_route, E=E, k=k, capacity=capacity),
                   (rep, rep), (rep,) * 7)
    buf, se, st, pos, sg, probs, first = route(x.reshape(T, d), p["router"])
    aux = _aux(probs, first, E)
    buf = maybe_shard(buf, "model", None, None)
    out_buf = _experts(buf, p, cfg, coded, ())
    out = local(functools.partial(_unpack, T=T), (rep,) * 5, (rep,))(
        out_buf, se, st, pos, sg)
    return maybe_shard(out.reshape(B, S, d), "dp", None, None), aux


def moe_apply(x: torch.Tensor, p: dict, cfg):
    """x: (B, S, d) -> ((B, S, d), aux load-balance loss).

    ``opt_moe_local_dispatch`` is looked at first, as in the JAX package
    (its ``moe_apply`` returns ``moe_apply_local`` before it reads
    ``opt_coded_moe``), so local dispatch runs uncoded even with the code
    on.  The port keeps that departure of the reference."""
    if getattr(cfg, "opt_moe_local_dispatch", False):
        return moe_apply_local(x, p, cfg)
    return _moe(x, p, cfg, coded=getattr(cfg, "opt_coded_moe", False))


def _dp_chunks(T: int) -> int:
    """The number of token chunks: the active mesh's dp degree (pod x
    data), halved until it divides T, so each chunk's route and pack stay
    on one dp shard."""
    dp = meshctx.dp_size()
    while T % dp:
        dp //= 2
    return max(dp, 1)


def moe_apply_local(x: torch.Tensor, p: dict, cfg):
    """dp-chunk-local dispatch (``opt_moe_local_dispatch``): the flat (B S)
    tokens in X = ``_dp_chunks(T)`` chunks of Tl = T / X consecutive
    tokens, each routed and packed into its own (E, Cl, d) buffer with
    capacity Cl from its Tl tokens.  Under a ``DeviceMesh`` the chunk axis
    is placed over "dp" where X is the dp degree (else replicated: each
    rank routes every chunk) and each rank routes its own chunks in
    ``local_map`` (tokens are replicated over "model", so the buffer placed
    ("dp", "model", ...) is a local slice).  Where the batch divides among
    the dp shards, a shard's chunk is its own batch rows: no dispatch
    collective.  Else the tokens are replicated over "dp" (``maybe_shard``)
    and each rank slices its chunks from them; the combined chunks are
    gathered back into the batch.  With one chunk and no ``DeviceMesh`` it
    is the global dispatch, uncoded."""
    B, S, d = x.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    T = B * S
    X = _dp_chunks(T)
    if X == 1 and meshctx.device_mesh() is None:
        return _moe(x, p, cfg, coded=False)
    Tl = T // X
    Cl = int(max(1, (Tl * k * cfg.moe.capacity_factor) // E))

    def route_chunks(xt, router):
        outs = [_route(xc, router, E, k, Cl) for xc in xt]
        return tuple(torch.stack(o) for o in zip(*outs, strict=True))

    cax = meshctx.fit(X, "dp")
    dp3, dp2 = (cax, None, None), (cax, None)
    rows = meshctx.fit(B, "dp") is not None
    if rows:
        # (B, S) tokens -> (X, Tl) chunks on each rank's own rows: the
        # chunk of a dp shard is its batch rows (DTensor's view rules
        # misplace the gradient of this reshape across sharded dims)
        xt = local(lambda t: t.reshape(-1, Tl, d), (dp3,), (dp3,))(x)
    else:
        xt = maybe_shard(x, None, None, None).reshape(X, Tl, d)
    # the router's gradient sums over the dp shards' chunks
    buf, se, st, pos, sg, probs, first = local(
        route_chunks, (dp3, ()), (dp3 + (None,), dp2, dp2, dp2, dp2, dp3, dp3),
        grad_partial={1: ("pod", "data")} if cax else None)(xt, p["router"])
    aux = _aux(probs, first, E)
    buf = maybe_shard(buf, cax, "model", None, None)         # a local slice
    out_buf = _experts(buf, p, cfg, False, (cax,))
    out = _combine(out_buf, se, st, pos, sg, Tl, E, cfg)
    if rows:
        return local(lambda t: t.reshape(-1, S, d), (dp3,), (dp3,))(out), aux
    return maybe_shard(out, None, None, None).reshape(B, S, d), aux


class _SumOverModel(torch.autograd.Function):
    """The bf16 all-reduce of the partials over the "model" group, whose
    backward is the identity: the output is replicated over "model", so
    each rank's partial gets the whole gradient."""

    @staticmethod
    def forward(ctx, partial, group):
        import torch.distributed as dist

        out = partial.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _combine(out_buf, se, st, pos, sg, Tl: int, E: int, cfg) -> torch.Tensor:
    """The local dispatch's unpack of (X, E, Cl, d) expert outputs back to
    (X, Tl, d) tokens.

    Default: each chunk's gather and scatter-add (``_unpack``), the
    expert rows first gathered from their "model" shards.

    ``opt_moe_shardmap_combine`` (the reference's hand-written
    ``shard_map``), under a ``DeviceMesh`` with "model", E divisible among
    the model shards and one chunk per dp shard: rank (dp, j) gathers only
    the rows of experts [j E/tp, (j+1) E/tp), scatter-adds them into an f32
    (Tl, d) partial, and one bf16 ``all_reduce`` over "model" sums the
    partials."""
    mesh = meshctx.device_mesh()
    X = out_buf.shape[0]
    tp = meshctx.axis_size("model")
    cax = meshctx.fit(X, "dp")
    dp4, dp2 = (cax, None, None, None), (cax, None)
    use_shardmap = (cfg.opt_moe_shardmap_combine and mesh is not None
                    and "model" in mesh.mesh_dim_names and E % tp == 0
                    and X == meshctx.dp_size())
    if not use_shardmap:
        def unpack_chunks(ob, se_, st_, pos_, sg_):
            return torch.stack([_unpack(*c, T=Tl) for c in zip(ob, se_, st_, pos_, sg_,
                                                                 strict=True)])
        return local(unpack_chunks, (dp4,) + (dp2,) * 4, ((cax, None, None),))(
            out_buf, se, st, pos, sg)

    E_loc = E // tp
    group = mesh["model"].get_group()
    e0 = mesh["model"].get_local_rank() * E_loc

    def local_fn(ob, se_, st_, pos_, sg_):
        # ob: (1, E_loc, Cl, d) this rank's experts; the indices (1, Tl*k)
        rel = se_[0] - e0
        mine = (rel >= 0) & (rel < E_loc)
        rows = ob[0][rel.clamp(0, E_loc - 1), pos_[0]]        # (Tl*k, d)
        contrib = torch.where(mine[:, None], rows * sg_[0][:, None], 0)
        partial = torch.zeros((Tl, ob.shape[-1]), dtype=torch.float32, device=ob.device)
        partial.index_put_((st_[0],), contrib.float(), accumulate=True)
        return _SumOverModel.apply(partial.to(torch.bfloat16), group).to(ob.dtype)[None]

    # a rank's gates get the gradient of its own experts' rows only
    return local(local_fn, (("dp", "model", None, None),) + (dp2,) * 4,
                  (("dp", None, None),), grad_partial={4: ("model",)})(
        out_buf, se, st, pos, sg)
