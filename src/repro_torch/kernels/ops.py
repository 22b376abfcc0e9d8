"""The port's kernel entry points, with one lane rule, by device.

Four entry points, with the JAX package's signatures
(``src/repro/kernels/ops.py``) less its ``interpret`` and ``lane``:

* ``spmm_block_fused`` / ``spmm_block_fused_decode`` -- the fused-gather
  block-sparse SpMM of the coded main path (``kernels.spmm_block``);
* ``spmm_block``   -- the plain block-ELL C = A^T B (``kernels.spmm_block``);
* ``coded_accum``  -- the dense coded accumulation (``kernels.coded_accum``).

Operands on a CUDA device go to the CUDA kernel, which launches or raises;
operands on the CPU go to the plain PyTorch version (``kernels.ref``).
There is no other lane and no override: a CUDA tensor never takes the plain
version.  The shape contracts the JAX package enforces (``s % s_chunk``,
``t % t_tile``, ``s % bs``) raise the same ``ValueError`` on both lanes.

Each call is one unit to a program capture (``KERNEL_SCOPE``), on both
lanes, as a ``pallas_call`` is one equation of a staged JAX program.
"""

from __future__ import annotations

import contextvars
from functools import partial

import torch

from repro_torch.kernels import coded_accum as _accum_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import spmm_block as _spmm_kernel

#: the program capture recording in this context
#: (``repro_torch.analysis.contracts.ProgramCapture``), or None.  Under one,
#: an entry point's call is recorded as one record -- its name, operands and
#: output -- and the ops it runs inside are not recorded one by one.  The
#: scope changes no result: the same lane runs the same code.
KERNEL_SCOPE: contextvars.ContextVar = contextvars.ContextVar("kernel_scope", default=None)


def _scoped(name: str, operands: tuple, run):
    capture = KERNEL_SCOPE.get()
    return run() if capture is None else capture.kernel(name, operands, run)


def _lane(*tensors: torch.Tensor) -> str:
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no kernel lane for device type {kind!r}")
    return kind


def spmm_block_fused(vals, src, wslot, B, *, bt: int, t_tile: int = 128):
    """One worker's coded local product, (CB * bs, bt) f32."""
    if _lane(vals, src, wslot, B) == "cuda":
        run = partial(_spmm_kernel.spmm_block_fused, vals, src, wslot, B, bt=bt,
                      t_tile=t_tile)
    else:
        run = partial(ref.spmm_block_fused_ref, vals, src, wslot, B, bt)
    return _scoped("spmm_block_fused", (vals, src, wslot, B), run)


def spmm_block_fused_decode(vals, src, wslot, dvec, B, *, bt: int,
                            t_tile: int = 128):
    """One-launch coded local product + decode combine: (mn, CB * bs, bt) f32.

    dvec is this worker's survivor decode column ``D[:, k] * alive_k``
    (mn,); the output stacks the mn decode-weighted copies of the local
    product, ready for the sum over workers.
    """
    if _lane(vals, src, wslot, dvec, B) == "cuda":
        run = partial(_spmm_kernel.spmm_block_fused_decode, vals, src, wslot, dvec, B,
                      bt=bt, t_tile=t_tile)
    else:
        run = partial(ref.spmm_block_fused_decode_ref, vals, src, wslot, dvec, B, bt)
    return _scoped("spmm_block_fused_decode", (vals, src, wslot, dvec, B), run)


def spmm_block(vals, idx, B, *, t_tile: int = 128):
    """C = A^T B, A in block-ELL: vals (CB, L, bs, bs), idx (CB, L), B (s, t).
    Returns (CB * bs, t) f32.  t must divide by t_tile, s by bs."""
    bs = vals.shape[2]
    s, t = B.shape
    if t % t_tile:
        raise ValueError(f"t={t} not divisible by t_tile={t_tile}")
    if s % bs:
        raise ValueError(f"s={s} not divisible by block size {bs}")
    if _lane(vals, idx, B) == "cuda":
        run = partial(_spmm_kernel.spmm_block, vals, idx, B, t_tile=t_tile)
    else:
        run = partial(ref.spmm_block_ref, vals, idx, B)
    return _scoped("spmm_block", (vals, idx, B), run)


def coded_accum(A, B, cols, weights, *, m: int, n: int, s_chunk: int = 128):
    """C~ = sum_l weights[l] * A_{i_l}^T B_{j_l}, (i, j) = divmod(cols[l], n).

    A (s, r), B (s, t); cols/weights (L,) task table (padded with w=0).
    Returns (r/m, t/n) f32.  s must divide by s_chunk.
    """
    s = A.shape[0]
    if s % s_chunk:
        raise ValueError(f"s={s} not divisible by s_chunk={s_chunk}")
    if _lane(A, B, cols, weights) == "cuda":
        run = partial(_accum_kernel.coded_accum, A, B, cols, weights, m=m, n=n)
    else:
        run = partial(ref.coded_accum_ref, A, B, cols, weights, m, n)
    return _scoped("coded_accum", (A, B, cols, weights), run)
