"""Block-sparse SpMM on the card: the wrappers of the CUDA kernels.

The CUDA C++ source is ``csrc/spmm_block.cu`` (one templated kernel, the
decode epilogue and the plain form compile-time flags);
``repro_torch.kernels.build`` compiles it on first use.  Three entry
points, the counterparts of the JAX package's Pallas kernels in
``src/repro/kernels/spmm_block.py``:

* ``spmm_block_fused``        -- ``_spmm_block_fused_pallas``: one worker's
  coded local product C~ = sum_l w * tile^T @ B[row-block, column group],
  (CB*bs, bt) f32;
* ``spmm_block_fused_decode`` -- ``_spmm_block_fused_decode_pallas``: the
  same slot loop with the survivor decode column in the epilogue,
  (mn, CB*bs, bt) f32 with out[c] = dvec[c] * C~, bit for bit;
* ``spmm_block``              -- ``spmm_block``: the plain block-ELL product
  C = A^T B, the same slot loop with w = 1 and one column group of width t,
  (CB*bs, t) f32.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape,
contiguity and index ranges, allocates its output with ``torch.empty``,
launches on the current stream, raises on a nonzero ``cudaError_t``, and
adds one to its count in ``LAUNCHES``.  The lane choice (kernel for a CUDA
tensor, plain version for a CPU tensor) is ``repro_torch.kernels.ops``'s.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import (check_cuda_operands, load_library,
                                      raise_on_error)

#: launches of each kernel in this process, counted where the kernel is
#: launched and nowhere else
LAUNCHES = {"spmm_block_fused": 0, "spmm_block_fused_decode": 0,
            "spmm_block": 0}

#: tile dtypes the kernel reads, by the code its C interface takes
VALS_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: tile edges the kernel is instantiated for
BLOCK_SIZES = (8, 16)
_MAX_THREADS = 1024
_MAX_GRID_Y = 65535
_INT_MAX = 2**31 - 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_tiles(vals, t_tile: int, ncols: int) -> tuple[int, int, int]:
    """vals (CB, L, bs, bs) of a dtype and edge the kernel is built for,
    and a t_tile that tiles ncols output columns in one launch."""
    if vals.dtype not in VALS_DTYPES:
        raise ValueError(f"vals dtype {vals.dtype} not in {list(VALS_DTYPES)}")
    if vals.dim() != 4 or vals.shape[2] != vals.shape[3]:
        raise ValueError(f"vals must be (CB, L, bs, bs), got {tuple(vals.shape)}")
    CB, L, bs, _ = vals.shape
    if bs not in BLOCK_SIZES:
        raise ValueError(f"block size {bs} not in {BLOCK_SIZES}")
    if not 1 <= t_tile <= _MAX_THREADS or -(-ncols // t_tile) > _MAX_GRID_Y:
        raise ValueError(f"t_tile={t_tile} does not tile {ncols} columns in "
                         "one launch")
    return CB, L, bs


def _check_operands(vals, src, wslot, B, bt: int, t_tile: int, dvec=None):
    """Refuse anything the kernel does not take; returns (CB, L, bs, s, t)."""
    named = {"vals": vals, "src": src, "wslot": wslot, "B": B}
    if dvec is not None:
        named["dvec"] = dvec
    check_cuda_operands(named, B)
    for name, want in (("src", torch.int32), ("wslot", torch.float32),
                       ("B", torch.float32), ("dvec", torch.float32)):
        if name in named and named[name].dtype != want:
            raise ValueError(f"{name} must be {want}, got {named[name].dtype}")
    if B.dim() != 2:
        raise ValueError(f"B must be 2-D, got {tuple(B.shape)}")
    CB, L, bs = _check_tiles(vals, t_tile, bt)
    if tuple(src.shape) != (CB, L, 2) or tuple(wslot.shape) != (CB, L):
        raise ValueError(
            f"src {tuple(src.shape)} / wslot {tuple(wslot.shape)} do not "
            f"match vals (CB={CB}, L={L})")
    s, t = B.shape
    if bt < 1 or t % bt:
        raise ValueError(f"t={t} not divisible by column-group width bt={bt}")
    if s % bs:
        raise ValueError(f"s={s} not divisible by block size {bs}")
    if dvec is not None and dvec.dim() != 1:
        raise ValueError(f"dvec must be 1-D, got {tuple(dvec.shape)}")
    if max(CB, L, s, t) > _INT_MAX:
        raise ValueError("operand dimension beyond the kernel's 32-bit sizes")
    if CB * L:
        # an index out of range would read outside B: check on the device,
        # one small reduction and one synchronisation
        lo, hi = src.amin(dim=(0, 1)), src.amax(dim=(0, 1))
        lo_rb, lo_grp, hi_rb, hi_grp = torch.cat([lo, hi]).tolist()
        if min(lo_rb, lo_grp) < 0 or hi_rb >= s // bs or hi_grp >= t // bt:
            raise ValueError(
                f"src indices outside [0, {s // bs}) x [0, {t // bt}): the "
                "pack was built for other operands")
    return CB, L, bs, s, t


def spmm_block_fused(vals: torch.Tensor, src: torch.Tensor,
                     wslot: torch.Tensor, B: torch.Tensor, *, bt: int,
                     t_tile: int = 128) -> torch.Tensor:
    """C~ = sum_l wslot[cb,l] * vals[cb,l]^T @ B[src rows, src column group]
    on the card: (CB * bs, bt) f32.  ``t_tile`` is the output columns of one
    thread block (its thread count)."""
    CB, L, bs, s, t = _check_operands(vals, src, wslot, B, bt, t_tile)
    out = torch.empty((CB * bs, bt), dtype=torch.float32, device=B.device)
    if out.numel() == 0:
        return out
    lib = load_library("spmm_block")
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spmm_block_fused(
            vals.data_ptr(), VALS_DTYPES[vals.dtype], bs, src.data_ptr(),
            wslot.data_ptr(), B.data_ptr(), out.data_ptr(), CB, L, t, bt,
            t_tile, stream)
    raise_on_error(err, "spmm_block_fused")
    LAUNCHES["spmm_block_fused"] += 1
    return out


def spmm_block_fused_decode(vals: torch.Tensor, src: torch.Tensor,
                            wslot: torch.Tensor, dvec: torch.Tensor,
                            B: torch.Tensor, *, bt: int,
                            t_tile: int = 128) -> torch.Tensor:
    """The one-launch local product + decode combine on the card:
    (mn, CB * bs, bt) f32, out[c] = dvec[c] * C~ with C~ as
    ``spmm_block_fused`` computes it, bit for bit."""
    CB, L, bs, s, t = _check_operands(vals, src, wslot, B, bt, t_tile, dvec)
    (mn,) = dvec.shape
    out = torch.empty((mn, CB * bs, bt), dtype=torch.float32, device=B.device)
    if out.numel() == 0:
        return out
    lib = load_library("spmm_block")
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spmm_block_fused_decode(
            vals.data_ptr(), VALS_DTYPES[vals.dtype], bs, src.data_ptr(),
            wslot.data_ptr(), dvec.data_ptr(), B.data_ptr(), out.data_ptr(),
            CB, L, t, bt, mn, t_tile, stream)
    raise_on_error(err, "spmm_block_fused_decode")
    LAUNCHES["spmm_block_fused_decode"] += 1
    return out


def spmm_block(vals: torch.Tensor, idx: torch.Tensor, B: torch.Tensor, *,
               t_tile: int = 128) -> torch.Tensor:
    """C = A^T B with A in block-ELL, on the card: C[cb*bs:+bs] =
    sum_l vals[cb,l]^T @ B[idx[cb,l]*bs:+bs], (CB * bs, t) f32.

    vals (CB, L, bs, bs) f32/bf16/int8, idx (CB, L) int32, B (s, t) f32 or
    bf16.  The kernel reads f32 B: a bf16 B is upcast here, which is exact.
    ``t_tile`` is the output columns of one thread block (its thread count).
    """
    check_cuda_operands({"vals": vals, "idx": idx, "B": B}, B)
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be {torch.int32}, got {idx.dtype}")
    if B.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"B must be float32 or bfloat16, got {B.dtype}")
    if B.dim() != 2:
        raise ValueError(f"B must be 2-D, got {tuple(B.shape)}")
    s, t = B.shape
    CB, L, bs = _check_tiles(vals, t_tile, t)
    if tuple(idx.shape) != (CB, L):
        raise ValueError(f"idx {tuple(idx.shape)} does not match vals "
                         f"(CB={CB}, L={L})")
    if s % bs:
        raise ValueError(f"s={s} not divisible by block size {bs}")
    if max(CB, L, s, t) > _INT_MAX:
        raise ValueError("operand dimension beyond the kernel's 32-bit sizes")
    if CB * L:
        # an index out of range would read outside B: one small reduction
        # and one synchronisation
        lo, hi = torch.aminmax(idx)
        if int(lo) < 0 or int(hi) >= s // bs:
            raise ValueError(f"idx outside [0, {s // bs}): the block-ELL was "
                             "built for another B")
    B = B.float()
    out = torch.empty((CB * bs, t), dtype=torch.float32, device=B.device)
    if out.numel() == 0:
        return out
    lib = load_library("spmm_block")
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spmm_block(vals.data_ptr(), VALS_DTYPES[vals.dtype], bs,
                             idx.data_ptr(), B.data_ptr(), out.data_ptr(), CB,
                             L, t, t_tile, stream)
    raise_on_error(err, "spmm_block")
    LAUNCHES["spmm_block"] += 1
    return out
