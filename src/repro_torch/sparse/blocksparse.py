"""Block-sparse substrate: block-granular sparsity in bs x bs tiles.

A matrix is a grid of bs x bs tiles, and only nonzero tiles are stored and
multiplied.  Format ("block-ELL", column-block major, read by the fused
SpMM kernels through the worker tile pack):

  vals : (n_col_blocks, L, bs, bs)   packed nonzero tiles (zero-padded rows)
  idx  : (n_col_blocks, L)           source row-block index of each tile
  nnzb : (n_col_blocks,)             how many of the L slots are live

For C = A^T B, column-blocks of A are row-blocks of C, so each output row
block consumes exactly one (vals[rb], idx[rb]) stripe.

A copy of the JAX package's numpy module (the packs of both packages must
agree bit for bit).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BlockELL:
    vals: np.ndarray   # (CB, L, bs, bs)
    idx: np.ndarray    # (CB, L) int32
    nnzb: np.ndarray   # (CB,) int32
    shape: tuple[int, int]  # dense (rows, cols)
    block_size: int

    @property
    def num_col_blocks(self) -> int:
        return self.vals.shape[0]

    @property
    def slots(self) -> int:
        return self.vals.shape[1]

    def density(self) -> float:
        rb = self.shape[0] // self.block_size
        return float(self.nnzb.sum()) / (rb * self.num_col_blocks)


def dense_to_block_ell(A: np.ndarray, block_size: int = 8,
                       slots: int | None = None) -> BlockELL:
    """Pack a dense matrix into block-ELL (keeps every nonzero tile).

    slots: pad/truncate the per-column-block tile count to this many slots
    (default: the max over column blocks).  Truncation drops the
    smallest-magnitude tiles.

    Per-column-block tile selection is one stable argsort on (live, energy)
    keys, so packing cost is O(CB * RB log RB) NumPy ops.
    """
    rows, cols = A.shape
    bs = block_size
    if rows % bs or cols % bs:
        raise ValueError(f"shape {A.shape} not divisible by block_size {bs}")
    RB, CB = rows // bs, cols // bs
    tiles = A.reshape(RB, bs, CB, bs).transpose(2, 0, 1, 3)  # (CB, RB, bs, bs)
    energy = np.abs(tiles).sum(axis=(2, 3))                  # (CB, RB)
    live = energy > 0
    per_cb = live.sum(axis=1)
    L = int(slots if slots is not None else max(int(per_cb.max(initial=1)), 1))
    # live tiles first, largest energy first among them; dead tiles sort last
    order = np.argsort(np.where(live, -energy, np.inf), axis=1,
                       kind="stable")[:, :L]                 # (CB, min(L, RB))
    if L > RB:  # more slots than row blocks: pad with the dead sentinel
        order = np.pad(order, ((0, 0), (0, L - RB)), constant_values=RB)
    nnzb = np.minimum(per_cb, L).astype(np.int32)
    slot_live = np.arange(L)[None, :] < nnzb[:, None]        # (CB, L)
    # kept row-blocks in ascending order, sentinel RB pushed to the tail
    picked = np.sort(np.where(slot_live, order, RB), axis=1)
    idx = np.where(slot_live, picked, 0).astype(np.int32)
    gathered = tiles[np.arange(CB)[:, None], np.minimum(picked, RB - 1)]
    vals = np.where(slot_live[..., None, None], gathered,
                    np.zeros((), dtype=A.dtype))
    return BlockELL(vals=vals, idx=idx, nnzb=nnzb, shape=(rows, cols),
                    block_size=bs)


def block_ell_to_dense(b: BlockELL) -> np.ndarray:
    rows, cols = b.shape
    bs = b.block_size
    A = np.zeros((rows, cols), dtype=b.vals.dtype)
    for cb in range(b.num_col_blocks):
        for l in range(int(b.nnzb[cb])):
            rb = int(b.idx[cb, l])
            A[rb * bs:(rb + 1) * bs, cb * bs:(cb + 1) * bs] = b.vals[cb, l]
    return A
