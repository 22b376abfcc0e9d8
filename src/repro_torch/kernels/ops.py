"""Lane dispatch for the fused SpMM kernels: one rule, by device.

Operands on a CUDA device go to the CUDA kernel (``kernels.spmm_block``),
which launches or raises; operands on the CPU go to the plain PyTorch
version (``kernels.ref``).  There is no other lane and no override: a CUDA
tensor never takes the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import spmm_block


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
        return spmm_block.spmm_block_fused(vals, src, wslot, B, bt=bt,
                                           t_tile=t_tile)
    return ref.spmm_block_fused_ref(vals, src, wslot, B, bt)


def spmm_block_fused_decode(vals, src, wslot, dvec, B, *, bt: int,
                            t_tile: int = 128):
    """One-launch coded local product + decode combine: (mn, CB * bs, bt) f32.

    dvec is this worker's survivor decode column ``D[:, k] * alive_k``
    (mn,); the output stacks the mn decode-weighted copies of the local
    product, ready for the sum over workers.
    """
    if _lane(vals, src, wslot, dvec, B) == "cuda":
        return spmm_block.spmm_block_fused_decode(vals, src, wslot, dvec, B,
                                                  bt=bt, t_tile=t_tile)
    return ref.spmm_block_fused_decode_ref(vals, src, wslot, dvec, B, bt)
