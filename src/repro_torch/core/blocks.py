"""Blocks of the host master/worker path as torch tensors on one device.

The JAX package's host path computes on numpy arrays and ``scipy.sparse``
matrices.  The port computes on torch tensors in one of two layouts, dense
(strided) or sparse CSR, on the device a job names: the CUDA card unless
the caller asks for the CPU.  This module holds what the encoder, the
decoder and the runtime share about those blocks:

* ``resolve_device`` -- the port's device rule (``None`` is the card);
* ``to_device`` -- a numpy array, a scipy matrix or a tensor, on the
  device, once, keeping its dtype and its layout (scipy -> CSR);
* ``HeldA`` / ``hold_a_blocks`` -- A's column blocks with their transposes
  made once per job: torch has no product of a transposed CSR on CUDA
  without converting it, so ``A_i.T @ B_j`` must not transpose per
  product;
* ``zeros_like_block`` and ``split_columns`` -- what torch's CSR lacks
  (no slicing, no ``zeros_like``), done on the indices, never densely.

A sparse block never becomes dense here: an operation torch cannot do on
CSR raises.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card and raises where there is none; pass
    ``"cpu"`` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device {dev} is neither a CUDA device nor the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def is_csr(x) -> bool:
    return isinstance(x, torch.Tensor) and x.layout == torch.sparse_csr


def _csr_from_scipy(x: sp.spmatrix, device: torch.device) -> torch.Tensor:
    x = sp.csr_matrix(x)
    return torch.sparse_csr_tensor(
        torch.from_numpy(x.indptr.astype(np.int64)),
        torch.from_numpy(x.indices.astype(np.int64)),
        torch.from_numpy(x.data), size=x.shape,
        check_invariants=False).to(device)


def to_device(x, device: torch.device) -> torch.Tensor:
    """One block on ``device``: numpy -> dense, scipy -> CSR, a tensor as
    it is (strided or CSR).  The dtype is kept."""
    if isinstance(x, torch.Tensor):
        if x.layout not in (torch.strided, torch.sparse_csr):
            raise ValueError(f"block layout {x.layout} is neither dense nor CSR")
        return x.to(device)
    if sp.issparse(x):
        return _csr_from_scipy(x, device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def blocks_to_device(blocks, device: torch.device) -> list:
    return [to_device(b, device) for b in blocks]


class HeldA:
    """One column block A_i of A on the device, held with its transpose
    made once: ``.T`` is that stored A_i^T (CSR for a sparse block, a view
    for a dense one), so ``A_i.T @ B_j`` -- the product the encoder and the
    runtime write -- transposes nothing per product."""

    __slots__ = ("T",)

    def __init__(self, a_t: torch.Tensor):
        self.T = a_t


def transposed(a) -> torch.Tensor:
    """A_i^T of one block of A: the held transpose of a ``HeldA``, the
    view of a dense tensor.  A bare CSR block is refused, since its
    transpose would be converted again for every product."""
    if is_csr(a):
        raise ValueError(
            "a sparse CSR block of A must be held with its transpose "
            "(blocks.hold_a_blocks): A_i.T @ B_j would convert it per product")
    return a.T


def hold_a_blocks(A_blocks, device: torch.device) -> list[HeldA]:
    """A's column blocks on ``device``, each transposed once (scipy blocks
    on the host before the move)."""
    held = []
    for a in A_blocks:
        if isinstance(a, HeldA):
            held.append(HeldA(a.T.to(device)))
        elif sp.issparse(a):
            held.append(HeldA(_csr_from_scipy(a.T, device)))
        else:
            a = to_device(a, device)
            held.append(HeldA(a.t().to_sparse_csr() if is_csr(a) else a.T))
    return held


def zeros_like_block(x: torch.Tensor) -> torch.Tensor:
    """An all-zero block of x's shape, dtype, device and layout."""
    if not is_csr(x):
        return torch.zeros_like(x)
    idx = x.crow_indices().dtype
    return torch.sparse_csr_tensor(
        torch.zeros(x.shape[0] + 1, dtype=idx, device=x.device),
        torch.zeros(0, dtype=idx, device=x.device),
        torch.zeros(0, dtype=x.dtype, device=x.device), size=tuple(x.shape),
        check_invariants=False)


def split_columns(x: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """Column blocks of a CSR tensor (torch's CSR has no slicing): each
    block keeps the entries of its column range, found on the indices."""
    rows, cols = x.shape
    step = cols // parts
    crow, col, val = x.crow_indices(), x.col_indices(), x.values()
    row_of = torch.repeat_interleave(
        torch.arange(rows, device=x.device), crow[1:] - crow[:-1])
    out = []
    for p in range(parts):
        keep = (col >= p * step) & (col < (p + 1) * step)
        counts = torch.bincount(row_of[keep], minlength=rows)
        crow_p = torch.zeros(rows + 1, dtype=crow.dtype, device=x.device)
        crow_p[1:] = torch.cumsum(counts, 0)
        out.append(torch.sparse_csr_tensor(
            crow_p, col[keep] - p * step, val[keep], size=(rows, step),
            check_invariants=False))
    return out
