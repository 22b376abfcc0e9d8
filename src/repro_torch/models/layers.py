"""Shared model layers: parameter defs, norms, activations, RoPE, the MLP.

Plain functions on tensors, computing what the JAX package's layers compute
in the same dtypes: the norms reduce in f32 (f64 for an f64 input) and
cast back before the scale,
RoPE rotates halves (not pairs) in f32, and ``gelu`` is the tanh form.  The
two causal-LM cross-entropy functions (``cross_entropy_chunked`` and
``cross_entropy_fused``) scan token chunks and never hold the (T, V) logits.

Under a ``DeviceMesh`` (``launch.meshctx``) the tensors are DTensors and
``maybe_shard`` places the MLP's hidden, the logits and the fused cross
entropy's backward products where the JAX package constrains them; with
no mesh each call is the tensor itself.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import meshctx
from repro_torch.launch.meshctx import maybe_shard


# ------------------------------ param defs ---------------------------------

@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: a shape, an init rule and a placement (the
    mesh axis names each dimension is sharded over, as the JAX package's
    ``PartitionSpec`` axes; ``()`` is replicated)."""

    shape: tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones | small_normal
    spec: tuple = ()

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


def tree_shapes(defs: dict, dtype: torch.dtype = torch.float32,
                device="meta") -> dict:
    """The tree of ``tree_init`` as empty tensors (meta by default: shapes
    and dtypes without storage, the JAX package's ``ShapeDtypeStruct``s)."""
    return {k: (torch.empty(v.shape, dtype=dtype, device=device)
                if isinstance(v, ParamDef) else tree_shapes(v, dtype, device))
            for k, v in defs.items()}


def tree_specs(defs: dict) -> dict:
    """The tree of each ``ParamDef``'s placement tuple."""
    return {k: v.spec if isinstance(v, ParamDef) else tree_specs(v)
            for k, v in defs.items()}


# ------------------------------- norms -------------------------------------

def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or in f64 where it is f64: the dtype the reductions run in."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = _acc(x).square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = _acc(x)
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


def sinusoidal_positions(seq: int, d: int, device=None, start: int = 0) -> torch.Tensor:
    """Rows ``start`` .. ``start + seq`` of the (max_seq, d) sinusoidal table
    (each row depends on its position alone, so a slice of the table is
    made without the table)."""
    pos = torch.arange(start, start + seq, dtype=torch.float32, device=device)[:, None]
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
    h = maybe_shard(h, "dp", None, "model")
    out = h @ p["w_down"]
    if bias:
        out = out + p["b_down"]
    return out


def mlp_defs(d: int, ff: int, act: str, bias: bool) -> dict:
    defs = {
        "w_up": ParamDef((d, ff), spec=("data", "model")),
        "w_down": ParamDef((ff, d), spec=("model", "data")),
    }
    if act == "silu":
        defs["w_gate"] = ParamDef((d, ff), spec=("data", "model"))
    if bias:
        defs["b_up"] = ParamDef((ff,), init="zeros", spec=("model",))
        defs["b_down"] = ParamDef((d,), init="zeros", spec=())
    return defs


# ------------------------------ LM losses -----------------------------------

def _chunks(x: torch.Tensor, labels: torch.Tensor, chunk: int):
    """x (T, d) and labels (T,) padded to a multiple of ``chunk`` (labels
    with -1, which count for nothing), split into token chunks."""
    pad = (-x.shape[0]) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    return zip(x.split(chunk), labels.split(chunk))


def _label_logit(logits: torch.Tensor, lch: torch.Tensor) -> torch.Tensor:
    """Each row's logit at its label (any value where the label is -1:
    the caller weights those rows by 0).  Over vocab-sharded logits the
    gathered column is placed before it is squeezed: DTensor's masked
    partial of a gather resolves only in the gather's own shape."""
    picked = logits.gather(-1, lch.clamp_min(0)[:, None].long())
    return maybe_shard(picked, "dp", None)[:, 0]


def _chunk_nll(xch: torch.Tensor, head_w: torch.Tensor, lch: torch.Tensor,
               logit_dtype: torch.dtype, mesh=None):
    with meshctx.use_mesh(mesh), meshctx.replicate_plain():
        return _chunk_nll_in(xch, head_w, lch, logit_dtype)


def _chunk_nll_in(xch, head_w, lch, logit_dtype):
    logits = maybe_shard((xch @ head_w).to(logit_dtype), "dp", "model")
    lse = torch.logsumexp(logits, dim=-1)
    valid = (lch >= 0).float()
    return ((lse - _label_logit(logits, lch)) * valid).sum(), valid.sum()


def cross_entropy_chunked(x: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
                          *, chunk: int = 4096,
                          logit_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Causal-LM cross entropy without materialising the (T, V) logits.

    x: (T, d) final hidden states; head_w: (d, V); labels: (T,) int, -1
    for none.  Each token chunk's logits are formed, reduced to its summed
    NLL and dropped; ``torch.utils.checkpoint`` rebuilds them chunk by
    chunk in the backward pass (the reference's ``jax.checkpoint``), so
    the peak is one chunk x V.  Returns the mean NLL over labelled tokens
    (f32).  The recompute may run on autograd's device thread, so the mesh
    is passed in, not read from the context there."""
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    mesh = meshctx.get_mesh()
    for xch, lch in _chunks(x, labels, chunk):
        s, c = checkpoint(_chunk_nll, xch, head_w, lch, logit_dtype, mesh,
                          use_reentrant=False)
        tot, cnt = tot + s, cnt + c
    return tot / cnt.clamp_min(1.0)


def _softmax_pieces(xch: torch.Tensor, head_w: torch.Tensor, lch: torch.Tensor):
    """The chunk's f32 softmax, its summed NLL and the labelled-row mask."""
    logits = maybe_shard((xch @ head_w).float(), "dp", "model")
    m = logits.amax(-1, keepdim=True)
    expl = torch.exp(logits - m)
    sumexp = expl.sum(-1, keepdim=True)
    lse = (m + torch.log(sumexp))[:, 0]
    valid = (lch >= 0).float()
    nll = ((lse - _label_logit(logits, lch)) * valid).sum()
    return expl / sumexp, nll, valid


def _minus_label(probs: torch.Tensor, lch: torch.Tensor, valid: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """``probs`` (rows, vocab) less ``valid`` at each row's label, in place:
    the columns of this rank's vocab shard where the ``vocab`` columns are
    sharded over "model" (DTensor's split: shards of ceil(vocab / tp), the
    last ones shorter where tp does not divide it)."""
    cols = lch.clamp_min(0).long()
    mesh = meshctx.device_mesh()
    if mesh is not None and "model" in mesh.mesh_dim_names:
        model = mesh["model"]
        cols = cols - model.get_local_rank() * -(-vocab // model.size())
        inside = (cols >= 0) & (cols < probs.shape[1])
        cols, valid = cols.clamp(0, probs.shape[1] - 1), torch.where(inside, valid, 0)
    rows = torch.arange(lch.shape[0], device=lch.device)
    return probs.index_put_((rows, cols), -valid, accumulate=True)


def _minus_label_placed(probs, lch: torch.Tensor, valid: torch.Tensor):
    """``_minus_label`` on vocab-sharded ``probs``: on each rank's own
    shard, since DTensor has no in-place rule for it, and not through
    ``meshctx.local``, whose ``local_map`` gives its output the shape of an
    even split (V = tp * the shard) where tp does not divide V."""
    from torch.distributed.tensor import DTensor

    if not isinstance(probs, DTensor):
        return _minus_label(probs, lch, valid, probs.shape[1])

    def own(t, *axes):
        t = maybe_shard(t, *axes)
        return t.to_local() if isinstance(t, DTensor) else t

    probs = maybe_shard(probs, "dp", "model")
    _minus_label(probs.to_local(), own(lch, "dp"), own(valid, "dp"), probs.shape[1])
    return probs


class _FusedChunkNLL(torch.autograd.Function):
    """One chunk's (summed NLL, label count) with the reference's
    hand-written backward (``_fused_chunk_nll``): only (xch, head_w, lch)
    are saved, the softmax is recomputed, and the two backward products
    run in bf16 -- ``dlogits``, ``head_w`` and ``xch`` are cast to bf16 at
    the reference's places, so the gradient rounds as the reference's does.
    The backward may run on autograd's device thread: it reads the mesh
    the forward saved."""

    @staticmethod
    def forward(ctx, xch, head_w, lch):
        _, nll, valid = _softmax_pieces(xch, head_w, lch)
        ctx.save_for_backward(xch, head_w, lch)
        ctx.mesh = meshctx.get_mesh()
        return nll, valid.sum()

    @staticmethod
    def backward(ctx, g_nll, g_cnt):
        xch, head_w, lch = ctx.saved_tensors
        with meshctx.use_mesh(ctx.mesh), meshctx.replicate_plain():
            probs, _, valid = _softmax_pieces(xch, head_w, lch)
            # probs - onehot(label) in place, the one-hot never built (rows
            # labelled -1 add -0 and are zeroed by ``valid`` below)
            probs = _minus_label_placed(probs, lch, valid)
            dlogits = (probs * (valid * g_nll)[:, None]).to(torch.bfloat16)
            dlogits = maybe_shard(dlogits, "dp", "model")
            dx = maybe_shard(dlogits @ head_w.to(torch.bfloat16).T, "dp", None).to(xch.dtype)
            dW = maybe_shard(xch.to(torch.bfloat16).T @ dlogits, None, "model").to(head_w.dtype)
        return dx, dW, None


def cross_entropy_fused(x: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
                        *, chunk: int = 4096) -> torch.Tensor:
    """``cross_entropy_chunked`` with the hand-written backward of
    ``_FusedChunkNLL`` (the reference's ``opt_fused_ce`` path)."""
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for xch, lch in _chunks(x, labels, chunk):
        s, c = _FusedChunkNLL.apply(xch, head_w, lch)
        tot, cnt = tot + s, cnt + c
    return tot / cnt.clamp_min(1.0)
