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

The kernel streams B through shared memory once per group of column
blocks, so each column block walks its slots in B's address order: each
wrapper makes that order (``slot_order``) on the device for every launch,
with no host synchronisation, and the kernel reads B by the copy path
``copy_path`` names.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape,
contiguity and index ranges, allocates its output with ``torch.empty``,
launches on the current stream, raises on a nonzero ``cudaError_t``, and
adds one to its count in ``LAUNCHES``.  The lane choice (kernel for a CUDA
tensor, plain version for a CPU tensor) is ``repro_torch.kernels.ops``'s.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import trace
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
#: the kernel's design, as ``spmm_block_geometry`` reports it
_GEOMETRY_KEYS = ("G", "cols", "stages", "chunk_rows", "a_depth", "threads",
                  "smem_bytes")
#: bytes a copy-engine copy of B needs its rows and start on
_WIDE_BYTES = 16


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def slot_order(src: torch.Tensor, bs_rows: int) -> torch.Tensor:
    """Each column block's slots sorted by the B tile they read: int32
    (..., CB, L), a stable sort by key = column group * bs_rows + row-block.

    ``src`` is (..., CB, L, 2) [row-block, column group] (a fused pack) or
    (..., CB, L, 1) [row-block] (a block-ELL's idx); ``bs_rows`` is s / bs.
    Any ``bs_rows`` above the largest row-block gives the same permutation.
    It depends on ``src`` alone, so the rebinds that change only the slot
    weights leave it valid.  Runs where ``src`` lies, with no host
    synchronisation.
    """
    with trace.span(trace.SLOT_ORDER):
        key = src[..., 0].long()
        if src.shape[-1] == 2:
            key = key + src[..., 1].long() * bs_rows
        return torch.argsort(key, dim=-1, stable=True).to(torch.int32)


def copy_path(B: torch.Tensor) -> str:
    """How the kernel reads this f32 B (s, t): ``"tma"`` (one copy-engine
    copy a tile) where its rows and start lie on 16 bytes, ``"cp_async_4"``
    (4-byte copies by the producer warp) otherwise.  The kernel takes the
    path it is given, and a tensor map the driver refuses is an error."""
    if (B.shape[-1] * B.element_size()) % _WIDE_BYTES or B.data_ptr() % _WIDE_BYTES:
        return "cp_async_4"
    return "tma"


def kernel_geometry(bs: int = 8) -> dict:
    """The design the kernel library was built with, for tile edge ``bs``:
    the column blocks of a thread block (G), its output columns, the ring's
    stages and rows a stage, the A tiles a warp has in flight, and the
    threads and shared bytes (f32 tiles) of a block.  Builds the library if
    need be."""
    out = (ctypes.c_int * len(_GEOMETRY_KEYS))()
    raise_on_error(load_library("spmm_block").spmm_block_geometry(
        bs, ctypes.cast(out, ctypes.c_void_p)), "spmm_block_geometry")
    return dict(zip(_GEOMETRY_KEYS, out))


def _check_tiles(vals, t_tile: int, ncols: int) -> tuple[int, int, int]:
    """vals (CB, L, bs, bs) of a dtype and edge the kernel is built for,
    on 16 bytes (the kernel copies tiles 16 bytes at a time), and a t_tile
    that tiles ncols output columns in one launch."""
    if vals.dtype not in VALS_DTYPES:
        raise ValueError(f"vals dtype {vals.dtype} not in {list(VALS_DTYPES)}")
    if vals.dim() != 4 or vals.shape[2] != vals.shape[3]:
        raise ValueError(f"vals must be (CB, L, bs, bs), got {tuple(vals.shape)}")
    CB, L, bs, _ = vals.shape
    if bs not in BLOCK_SIZES:
        raise ValueError(f"block size {bs} not in {BLOCK_SIZES}")
    if vals.data_ptr() % 16:
        raise ValueError("vals must start on a 16-byte boundary")
    if not 1 <= t_tile <= _MAX_THREADS or -(-ncols // t_tile) > _MAX_GRID_Y:
        raise ValueError(f"t_tile={t_tile} does not tile {ncols} columns in "
                         "one launch")
    return CB, L, bs


def _check_indices(src, bs_rows: int, n_groups: int) -> None:
    """src indices in range (an index out of range would read outside B): on
    the device, one small reduction and one synchronisation."""
    plain = src.shape[-1] == 1
    with trace.span(trace.CHECK_INDICES):
        lo, hi = src.amin(dim=(0, 1)), src.amax(dim=(0, 1))
        got = torch.cat([lo, hi]).tolist()
    k = src.shape[-1]
    lo_, hi_ = got[:k], got[k:]
    if plain and (lo_[0] < 0 or hi_[0] >= bs_rows):
        raise ValueError(f"idx outside [0, {bs_rows}): the block-ELL was "
                         "built for another B")
    if min(lo_) < 0 or hi_[0] >= bs_rows or (not plain and hi_[1] >= n_groups):
        raise ValueError(
            f"src indices outside [0, {bs_rows}) x [0, {n_groups}): the pack "
            "was built for other operands")


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
    if max(CB, L, s, t) > _INT_MAX or (s // bs) * (t // bt) > _INT_MAX - 64:
        raise ValueError("operand dimension beyond the kernel's 32-bit sizes")
    if CB * L:
        _check_indices(src, s // bs, t // bt)
    return CB, L, bs, s, t


def spmm_block_fused(vals: torch.Tensor, src: torch.Tensor,
                     wslot: torch.Tensor, B: torch.Tensor, *, bt: int,
                     t_tile: int = 128) -> torch.Tensor:
    """C~ = sum_l wslot[cb,l] * vals[cb,l]^T @ B[src rows, src column group]
    on the card: (CB * bs, bt) f32.

    ``t_tile`` is the JAX signature's column tile: it is checked as there
    (1 to 1024, at most 65535 tiles), and the kernel does not use it; its
    own column tile is fixed when it is built (``kernel_geometry``)."""
    CB, L, bs, s, t = _check_operands(vals, src, wslot, B, bt, t_tile)
    out = torch.empty((CB * bs, bt), dtype=torch.float32, device=B.device)
    if out.numel() == 0:
        return out
    order = slot_order(src, s // bs)
    lib = load_library("spmm_block")
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spmm_block_fused(
            vals.data_ptr(), VALS_DTYPES[vals.dtype], bs, src.data_ptr(),
            order.data_ptr(), wslot.data_ptr(), B.data_ptr(), out.data_ptr(),
            CB, L, s, t, bt, int(copy_path(B) == "tma"), stream)
    raise_on_error(err, "spmm_block_fused")
    LAUNCHES["spmm_block_fused"] += 1
    return out


def spmm_block_fused_decode(vals: torch.Tensor, src: torch.Tensor,
                            wslot: torch.Tensor, dvec: torch.Tensor,
                            B: torch.Tensor, *, bt: int,
                            t_tile: int = 128) -> torch.Tensor:
    """The one-launch local product + decode combine on the card:
    (mn, CB * bs, bt) f32, out[c] = dvec[c] * C~ with C~ as
    ``spmm_block_fused`` computes it, bit for bit.  ``t_tile`` as there."""
    CB, L, bs, s, t = _check_operands(vals, src, wslot, B, bt, t_tile, dvec)
    (mn,) = dvec.shape
    out = torch.empty((mn, CB * bs, bt), dtype=torch.float32, device=B.device)
    if out.numel() == 0:
        return out
    order = slot_order(src, s // bs)
    lib = load_library("spmm_block")
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spmm_block_fused_decode(
            vals.data_ptr(), VALS_DTYPES[vals.dtype], bs, src.data_ptr(),
            order.data_ptr(), wslot.data_ptr(), dvec.data_ptr(), B.data_ptr(),
            out.data_ptr(), CB, L, s, t, bt, mn, int(copy_path(B) == "tma"),
            stream)
    raise_on_error(err, "spmm_block_fused_decode")
    LAUNCHES["spmm_block_fused_decode"] += 1
    return out


def spmm_block(vals: torch.Tensor, idx: torch.Tensor, B: torch.Tensor, *,
               t_tile: int = 128) -> torch.Tensor:
    """C = A^T B with A in block-ELL, on the card: C[cb*bs:+bs] =
    sum_l vals[cb,l]^T @ B[idx[cb,l]*bs:+bs], (CB * bs, t) f32.

    vals (CB, L, bs, bs) f32/bf16/int8, idx (CB, L) int32, B (s, t) f32 or
    bf16.  The kernel reads f32 B: a bf16 B is upcast here, which is exact.
    ``t_tile`` as in ``spmm_block_fused``.
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
        _check_indices(idx[..., None], s // bs, 1)
    B = B.float()
    out = torch.empty((CB * bs, t), dtype=torch.float32, device=B.device)
    if out.numel() == 0:
        return out
    order = slot_order(idx[..., None], s // bs)
    lib = load_library("spmm_block")
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spmm_block(vals.data_ptr(), VALS_DTYPES[vals.dtype], bs,
                             idx.data_ptr(), order.data_ptr(), B.data_ptr(),
                             out.data_ptr(), CB, L, s, t,
                             int(copy_path(B) == "tma"), stream)
    raise_on_error(err, "spmm_block")
    LAUNCHES["spmm_block"] += 1
    return out
