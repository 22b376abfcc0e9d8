"""The plain reference of every cell, and the control that must fail it.

C = A^T B in float32 with TF32 off, in plain PyTorch on the operands the
harness drew; it needs nothing of the port (no code, no pack, no decode).
The control is the same product one precision below what the configuration
states: A and B rounded to TF32 (10 explicit mantissa bits, to nearest)
and multiplied with float32 sums, which is what TF32 tensor cores compute,
and the same on any device.  The comparison is the widest gap of an answer
from the reference, over the reference's largest magnitude.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32(enabled: bool):
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def product(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^T B in float32, TF32 off."""
    with tf32(False):
        return A.T @ B


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 explicit mantissa bits, to nearest
    (ties away from zero, as the tensor cores' conversion does)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
    return bits.view(torch.float32)


def control_product(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The control: A^T B with the operands at TF32 precision."""
    return product(round_tf32(A), round_tf32(B))


def rel_err(C: torch.Tensor, ref: torch.Tensor, scale: float | None = None) -> float:
    """max |C - ref| / ``scale``, by default max |ref| (inf where C is not
    finite or of another shape); rows of an answer are held to the whole
    reference's scale."""
    if tuple(C.shape) != tuple(ref.shape):
        return float("inf")
    gap = (C.to(ref.device, torch.float32) - ref).abs().max()
    if not torch.isfinite(gap):
        return float("inf")
    return float(gap) / (float(ref.abs().max()) if scale is None else scale)
