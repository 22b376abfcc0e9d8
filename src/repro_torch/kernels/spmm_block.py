"""Fused-gather block-sparse SpMM on the card: the wrappers of the CUDA kernels.

The CUDA C++ source is ``csrc/spmm_block.cu`` (one templated kernel, the
decode epilogue a compile-time flag); ``repro_torch.kernels.build``
compiles it on first use.  Two entry points, the counterparts of the JAX
package's Pallas kernels in ``repro/kernels/spmm_block.py``:

* ``spmm_block_fused``        -- ``_spmm_block_fused_pallas``: one worker's
  coded local product C~ = sum_l w * tile^T @ B[row-block, column group],
  (CB*bs, bt) f32;
* ``spmm_block_fused_decode`` -- ``_spmm_block_fused_decode_pallas``: the
  same slot loop with the survivor decode column in the epilogue,
  (mn, CB*bs, bt) f32 with out[c] = dvec[c] * C~, bit for bit.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape,
contiguity and index ranges, allocates its output with ``torch.empty``,
launches on the current stream, raises on a nonzero ``cudaError_t``, and
adds one to its count in ``LAUNCHES``.  The lane choice (kernel for a CUDA
tensor, plain version for a CPU tensor) is ``repro_torch.kernels.ops``'s.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import load_library

#: launches of each kernel in this process, counted where the kernel is
#: launched and nowhere else
LAUNCHES = {"spmm_block_fused": 0, "spmm_block_fused_decode": 0}

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


def _check_operands(vals, src, wslot, B, bt: int, t_tile: int, dvec=None):
    """Refuse anything the kernel does not take; returns (CB, L, bs, s, t)."""
    named = {"vals": vals, "src": src, "wslot": wslot, "B": B}
    if dvec is not None:
        named["dvec"] = dvec
    for name, x in named.items():
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got "
                             f"{getattr(x, 'device', type(x))}")
        if x.device != B.device:
            raise ValueError(f"{name} lies on {x.device}, B on {B.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if vals.dtype not in VALS_DTYPES:
        raise ValueError(f"vals dtype {vals.dtype} not in {list(VALS_DTYPES)}")
    for name, want in (("src", torch.int32), ("wslot", torch.float32),
                       ("B", torch.float32), ("dvec", torch.float32)):
        if name in named and named[name].dtype != want:
            raise ValueError(f"{name} must be {want}, got {named[name].dtype}")
    if vals.dim() != 4 or vals.shape[2] != vals.shape[3]:
        raise ValueError(f"vals must be (CB, L, bs, bs), got {tuple(vals.shape)}")
    CB, L, bs, _ = vals.shape
    if bs not in BLOCK_SIZES:
        raise ValueError(f"block size {bs} not in {BLOCK_SIZES}")
    if tuple(src.shape) != (CB, L, 2) or tuple(wslot.shape) != (CB, L):
        raise ValueError(
            f"src {tuple(src.shape)} / wslot {tuple(wslot.shape)} do not "
            f"match vals (CB={CB}, L={L})")
    if B.dim() != 2:
        raise ValueError(f"B must be 2-D, got {tuple(B.shape)}")
    s, t = B.shape
    if bt < 1 or t % bt:
        raise ValueError(f"t={t} not divisible by column-group width bt={bt}")
    if s % bs:
        raise ValueError(f"s={s} not divisible by block size {bs}")
    if dvec is not None and dvec.dim() != 1:
        raise ValueError(f"dvec must be 1-D, got {tuple(dvec.shape)}")
    if not 1 <= t_tile <= _MAX_THREADS or -(-bt // t_tile) > _MAX_GRID_Y:
        raise ValueError(f"t_tile={t_tile} does not tile bt={bt} in one launch")
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


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


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
    _raise_on(err, "spmm_block_fused")
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
    _raise_on(err, "spmm_block_fused_decode")
    LAUNCHES["spmm_block_fused_decode"] += 1
    return out
