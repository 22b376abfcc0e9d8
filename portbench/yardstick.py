"""The yardstick: the card's peaks, and the least time each fused-decode
launch could take, counted from the work its inputs need.

A launch is one worker's local product with its decode combine (the
port's ``spmm_block_fused_decode``).  Its work is counted from the
configuration's code, A's live tiles and the apply's failure pattern, never
from how a kernel reads them, so the same inputs give the same count
whatever implements them:

* FLOPs: 2 bs^2 bt for each live slot, a nonzero code weight times a live
  tile of A in the stripe that weight reads;
* bytes: each live A tile the launch reads, once; each distinct B tile
  (row block, column group) its live slots read, once; its output
  (m n decode-weighted copies of its product), once;
* a dead worker's product is multiplied by 0 in the decode, so nothing of
  it is needed: its launch counts no work.

The bound is max(FLOPs / peak FLOP/s, bytes / peak bytes/s).
"""

from __future__ import annotations

import numpy as np

#: the published peaks a device kind is held to (NVIDIA's H100 SXM data
#: sheet: dense f32 on the CUDA cores, HBM3 bandwidth), at a 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "bytes_per_s": 3.35e12},
}

F32_BYTES = 4


def live_mask(rows: np.ndarray, nnzb: np.ndarray, s: int, bs: int) -> np.ndarray:
    """(RB, CB) bool: which tiles of A are live, from a block-ELL's row
    blocks (CB, L) of which the first ``nnzb`` (CB,) of each are live."""
    rows, nnzb = np.asarray(rows), np.asarray(nnzb)
    CB, L = rows.shape
    cb, slot = np.nonzero(np.arange(L)[None, :] < nnzb[:, None])
    live = np.zeros((s // bs, CB), dtype=bool)
    live[rows[cb, slot], cb] = True
    return live


def launch_work(coefficients, geometry: tuple, live: np.ndarray) -> list[dict]:
    """Each worker's launch with every worker alive: its live ``slots``,
    ``flops`` and ``bytes``.

    ``geometry`` is (s, r, t, bs, m, n); ``live`` is A's (RB, CB) tile mask."""
    s, r, t, bs, m, n = geometry
    M = np.asarray(coefficients)
    br, bt = r // m, t // n
    cbl = br // bs
    stripes = live.reshape(live.shape[0], m, cbl)             # (RB, m, CBl)
    tiles = stripes.sum(axis=(0, 2))                          # live tiles of stripe i
    rows_used = stripes.any(axis=2)                           # (RB, m)
    out = []
    for row in M:
        blocks = np.flatnonzero(row)
        i_of, j_of = blocks // n, blocks % n
        slots = int(tiles[i_of].sum())
        a_bytes = int(tiles[np.unique(i_of)].sum()) * bs * bs * F32_BYTES
        b_rows = sum(int(rows_used[:, np.unique(i_of[j_of == j])].any(axis=1).sum())
                     for j in np.unique(j_of))
        b_bytes = b_rows * bs * bt * F32_BYTES
        out_bytes = m * n * br * bt * F32_BYTES
        out.append({"slots": slots, "flops": 2 * bs * bs * bt * slots,
                    "bytes": a_bytes + b_bytes + out_bytes})
    return out


def bound_s(work: dict, peaks: dict) -> float:
    return max(work["flops"] / peaks["f32_flops"], work["bytes"] / peaks["bytes_per_s"])


def apply_bound_s(work: list[dict], dead: tuple[int, ...], peaks: dict) -> float:
    """The least time of one apply's launches under a dead set."""
    return sum(bound_s(w, peaks) for k, w in enumerate(work) if k not in dead)
