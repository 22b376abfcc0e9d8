"""Dense coded accumulation on the card: the wrapper of the CUDA kernel.

The CUDA C++ source is ``csrc/coded_accum.cu``; ``repro_torch.kernels.build``
compiles it on first use.  One entry point, the counterpart of the JAX
package's Pallas kernel ``coded_accum`` in
``src/repro/kernels/coded_accum.py``:

* ``coded_accum`` -- one worker's dense coded accumulation
  C~ = sum_l weights[l] * A[:, i*br:+br]^T @ B[:, j*bt:+bt] with
  (i, j) = divmod(cols[l], n), (r/m, t/n) f32.

The kernel runs on the tensor cores in 3xTF32 (``mma.sync``), fed by a
``cp.async`` ring; the source's header says why.  It has two copy paths,
both instances of the one kernel: 16-byte copies where the operands' rows,
blocks and addresses allow them, else one element a copy.  ``copy_path``
makes the choice from the shapes.

The wrapper takes CUDA tensors only: it checks device, dtype, shape,
contiguity and the range of ``cols``, allocates its output with
``torch.empty``, launches on the current stream, raises on a nonzero
``cudaError_t``, and adds one to its count in ``LAUNCHES``.  The lane choice
is ``repro_torch.kernels.ops``'s.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import (check_cuda_operands, load_library,
                                      raise_on_error)

#: launches of the kernel in this process, counted where it is launched and
#: nowhere else
LAUNCHES = {"coded_accum": 0}

#: operand dtypes the kernel reads, by the code its C interface takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
_TILE = 128             # output rows and columns of one thread block
_INT_MAX = 2**31 - 1
_WIDE_BYTES = 16        # one cp.async copy of the wide path


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def copy_path(a_dtype: torch.dtype, b_dtype: torch.dtype, r: int, t: int,
              br: int, bt: int, a_addr: int = 0, b_addr: int = 0) -> str:
    """The kernel's copy path for these operands: ``"wide"`` (16-byte
    copies) where each operand's row (r or t elements), column block (br or
    bt) and address lie on 16 bytes, so that every copy is whole and
    aligned; ``"narrow"`` (one element a copy) otherwise."""
    for dtype, width, block, addr in ((a_dtype, r, br, a_addr),
                                      (b_dtype, t, bt, b_addr)):
        size = dtype.itemsize
        if (width * size) % _WIDE_BYTES or (block * size) % _WIDE_BYTES \
                or addr % _WIDE_BYTES:
            return "narrow"
    return "wide"


def coded_accum(A: torch.Tensor, B: torch.Tensor, cols: torch.Tensor,
                weights: torch.Tensor, *, m: int, n: int) -> torch.Tensor:
    """C~ = sum_l weights[l] * A_{i_l}^T B_{j_l} on the card: (r/m, t/n) f32.

    A (s, r) and B (s, t) f32 or bf16; cols (L,) int32/int64 block ids in
    [0, m*n) (one small read to the host checks them); weights (L,) f32, a
    weight of 0 marking a pad.
    """
    check_cuda_operands({"A": A, "B": B, "cols": cols, "weights": weights}, B)
    for name, x in (("A", A), ("B", B)):
        if x.dtype not in DTYPES:
            raise ValueError(f"{name} dtype {x.dtype} not in {list(DTYPES)}")
        if x.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(x.shape)}")
    if cols.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"cols must be int32 or int64, got {cols.dtype}")
    if weights.dtype != torch.float32:
        raise ValueError(f"weights must be {torch.float32}, got {weights.dtype}")
    if cols.dim() != 1 or tuple(weights.shape) != tuple(cols.shape):
        raise ValueError(f"cols {tuple(cols.shape)} / weights "
                         f"{tuple(weights.shape)} must be one (L,) task table")
    s, r = A.shape
    if B.shape[0] != s:
        raise ValueError(f"A has {s} rows, B {B.shape[0]}")
    t = B.shape[1]
    if m < 1 or n < 1:
        raise ValueError(f"m={m}, n={n} must be positive")
    br, bt = r // m, t // n
    L = cols.shape[0]
    if max(s, r, t, L) > _INT_MAX or -(-br // _TILE) > _MAX_GRID_Y:
        raise ValueError("operand dimension beyond the kernel's 32-bit sizes")
    # a block id out of range would read outside A or B
    bad = [c for c in cols.tolist() if not 0 <= c < m * n]
    if bad:
        raise ValueError(f"cols {bad} outside [0, {m * n})")
    out = torch.empty((br, bt), dtype=torch.float32, device=B.device)
    if out.numel() == 0:
        return out
    cols32 = cols.to(torch.int32)
    wide = copy_path(A.dtype, B.dtype, r, t, br, bt, A.data_ptr(),
                     B.data_ptr()) == "wide"
    lib = load_library("coded_accum")
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.coded_accum(A.data_ptr(), DTYPES[A.dtype], B.data_ptr(),
                              DTYPES[B.dtype], cols32.data_ptr(),
                              weights.data_ptr(), out.data_ptr(), s, r, t, br,
                              bt, n, L, int(wide), stream)
    raise_on_error(err, "coded_accum")
    LAUNCHES["coded_accum"] += 1
    return out
