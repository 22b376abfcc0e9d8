"""Hybrid peeling + rooting decoder (paper Algorithm 1, Lemma 1).

The decoder is expressed in two phases:

1. ``peel_schedule(M)`` -- *structural* decoding.  The peel/root order depends
   only on the coefficient matrix M, never on the data blocks.  It runs
   Algorithm 1 once over M's sparsity pattern on the host (numpy, float64)
   and emits a static schedule of ops:

     ("peel", row, col, scale)          block[col] = scale * R[row]
     ("root", col, rows, coeffs)        block[col] = sum_r coeffs * R[rows]
     ("axpy", row, col, weight)         R[row] -= weight * block[col]

2. ``apply_schedule(schedule, results)`` -- replays the schedule on the data.
   Each op is a sparse AXPY costing O(nnz(block)), so total decode cost is
   O(#axpys * nnz-per-block) = O(nnz(C) * ln(mn)) under Wave Soliton -- the
   paper's Theorem 1.  Blocks are torch tensors on any device, dense or
   sparse CSR; a CSR block stays CSR through every op.

``peel_schedule`` is a copy of the JAX package's (the same ``set.pop()``
order and the same ``rng.choice`` draws), so a schedule is the reference's
bit for bit.  ``gaussian_decode`` is the dense oracle the paper's decoder
beats; ``decode_matrix`` is the device path's decode: decoding any
full-rank linear code is itself linear, so on the device it collapses to
one combine ``blocks = D @ results`` with D = pinv(M).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from repro_torch.core.blocks import zeros_like_block


class DecodingError(RuntimeError, ValueError):
    """Collected results cannot be decoded (rank-deficient coefficient rows).

    Subclasses both RuntimeError (historical) and ValueError so callers that
    treat rank loss as bad input -- e.g. ``CodedMatmulPlan.with_survivors``
    validation -- catch it either way.
    """


class IncrementalRankTracker:
    """Rank of a growing row set, maintained incrementally per arrival.

    Keeps an orthonormal basis of the collected row space and updates it
    per arrival with one modified-Gram-Schmidt pass (re-orthogonalized
    twice for float robustness): O(mn * rank) per ``add``, so a whole job is
    O(arrivals * mn * rank) instead of a ``matrix_rank`` per arrival.

    Float caveat: rank decisions near the tolerance can disagree with an
    exact check, so callers treating ``is_full`` as a decode gate should
    confirm once with the exact test when it first fires (the executor
    does) -- the tracker's job is to make the *per-event* check cheap, not
    to be the final authority.
    """

    def __init__(self, dim: int, tol: float = 1e-10):
        self.dim = int(dim)
        self.tol = float(tol)
        self.rank = 0
        self.rows_seen = 0  # rows folded in (feeds ExecutionReport.decode_stats)
        self._Q = np.zeros((self.dim, self.dim))  # rows 0..rank-1: the basis

    @property
    def is_full(self) -> bool:
        return self.rank >= self.dim

    def add(self, row: np.ndarray) -> bool:
        """Fold one row in; returns True iff it increased the rank."""
        self.rows_seen += 1
        if self.is_full:
            return False
        v = np.asarray(
            row.toarray() if sp.issparse(row) else row, dtype=np.float64
        ).reshape(-1)
        if v.shape[0] != self.dim:
            raise ValueError(f"row has {v.shape[0]} entries, tracker dim {self.dim}")
        nv = np.linalg.norm(v)
        if nv == 0.0 or not np.isfinite(nv):
            return False
        v = v / nv
        Q = self._Q[: self.rank]
        for _ in range(2):  # classic Gram-Schmidt with one re-orthogonalization
            v = v - Q.T @ (Q @ v)
        res = np.linalg.norm(v)
        if res <= self.tol:
            return False
        self._Q[self.rank] = v / res
        self.rank += 1
        return True


@dataclasses.dataclass
class DecodeStats:
    peels: int = 0
    roots: int = 0
    axpys: int = 0
    root_row_combines: int = 0  # rows combined across all rooting steps

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _adjacency(M: sp.spmatrix):
    """Row->cols / col->rows adjacency with weights, as mutable dicts."""
    Mc = sp.coo_matrix(M)
    row_cols: list[dict[int, float]] = [dict() for _ in range(M.shape[0])]
    col_rows: list[set[int]] = [set() for _ in range(M.shape[1])]
    for r, c, v in zip(Mc.row, Mc.col, Mc.data):
        if v == 0.0:
            continue
        row_cols[r][int(c)] = float(v)
        col_rows[int(c)].add(int(r))
    return row_cols, col_rows


def peel_schedule(
    M: sp.spmatrix | np.ndarray,
    rng: np.random.Generator | None = None,
    root_pick: str = "random",
    check_rank: bool = True,
):
    """Run Algorithm 1 structurally over M; return (schedule, stats).

    root_pick:
      "random"    -- paper's choice: uniformly random unrecovered block.
      "max_rows"  -- beyond-paper heuristic: pick the unrecovered block that
                     appears in the most active rows, maximizing the expected
                     number of new ripples per rooting step.
      "fail"      -- raise DecodingError instead of rooting (pure peeling,
                     i.e. LT-code decoding semantics).
    """
    M = sp.csr_matrix(M)
    K, d = M.shape
    if check_rank:
        rank = int(np.linalg.matrix_rank(M.toarray()))
        if rank < d:
            raise DecodingError(
                f"coefficient matrix rank {rank} < {d}; "
                "collect more results before decoding"
            )
    rng = rng or np.random.default_rng(0)
    row_cols, col_rows = _adjacency(M)
    recovered = np.zeros(d, dtype=bool)
    schedule: list[tuple] = []
    stats = DecodeStats()

    # Ripple set: rows whose residual degree is exactly 1.
    ripples = {r for r in range(K) if len(row_cols[r]) == 1}

    def subtract_block(col: int):
        """AXPY the recovered block out of every active row containing it."""
        for r in sorted(col_rows[col]):
            w = row_cols[r].pop(col)
            schedule.append(("axpy", r, col, w))
            stats.axpys += 1
            if len(row_cols[r]) == 1:
                ripples.add(r)
            elif len(row_cols[r]) == 0:
                ripples.discard(r)
        col_rows[col].clear()

    num_left = d
    while num_left > 0:
        ripple_row = None
        while ripples:
            r = ripples.pop()
            if len(row_cols[r]) == 1:
                ripple_row = r
                break
        if ripple_row is not None:
            (col, w), = row_cols[ripple_row].items()
            row_cols[ripple_row].clear()
            col_rows[col].discard(ripple_row)
            schedule.append(("peel", ripple_row, col, 1.0 / w))
            stats.peels += 1
            recovered[col] = True
            num_left -= 1
            subtract_block(col)
            continue

        # Rooting step (Lemma 1): no ripple exists.  Solve the residual
        # system restricted to unrecovered columns for a combination that
        # isolates block `col`.
        if root_pick == "fail":
            raise DecodingError("peeling stalled and rooting disabled")
        unrec = np.flatnonzero(~recovered)
        if root_pick == "max_rows":
            col = int(unrec[np.argmax([len(col_rows[c]) for c in unrec])])
        else:
            col = int(rng.choice(unrec))
        active_rows = sorted({r for c in unrec for r in col_rows[c]})
        if not active_rows:
            raise DecodingError("no active rows left but blocks unrecovered")
        R = np.zeros((len(active_rows), len(unrec)))
        for a, r in enumerate(active_rows):
            for c, w in row_cols[r].items():
                R[a, unrec.searchsorted(c)] = w
        e = np.zeros(len(unrec))
        e[unrec.searchsorted(col)] = 1.0
        # Solve R^T u = e  (least squares; consistent because M is full rank).
        u, residual, rank, _ = np.linalg.lstsq(R.T, e, rcond=None)
        if not np.allclose(R.T @ u, e, atol=1e-8):
            raise DecodingError("rooting solve failed; matrix not full rank?")
        nz = np.flatnonzero(np.abs(u) > 1e-12)
        rows = np.asarray([active_rows[i] for i in nz], dtype=np.int64)
        coeffs = u[nz]
        schedule.append(("root", col, rows, coeffs))
        stats.roots += 1
        stats.root_row_combines += len(rows)
        recovered[col] = True
        num_left -= 1
        subtract_block(col)

    return schedule, stats


def apply_schedule(schedule, results):
    """Replay a structural schedule on worker results.

    ``results``: list of torch tensors (dense or sparse CSR, on any device)
    indexed by row.  Returns the list of mn recovered blocks indexed by
    flat column.  Rows are consumed destructively on a shallow copy.
    """
    R = list(results)
    d = 1 + max(
        op[2] if op[0] != "root" else op[1] for op in schedule
    ) if schedule else 0
    blocks = [None] * d
    for op in schedule:
        kind = op[0]
        if kind == "peel":
            _, row, col, scale = op
            blocks[col] = R[row] * scale
        elif kind == "root":
            _, col, rows, coeffs = op
            acc = R[rows[0]] * float(coeffs[0])
            for r, u in zip(rows[1:], coeffs[1:]):
                acc = acc + R[r] * float(u)
            blocks[col] = acc
        elif kind == "axpy":
            _, row, col, w = op
            # torch's CSR has no subtraction; a + (b * -w) is a - b * w
            # bit for bit (negation is exact)
            R[row] = R[row] + blocks[col] * (-w)
        else:  # pragma: no cover
            raise ValueError(f"unknown op {kind}")
    return blocks


def hybrid_decode(M, results, rng=None, root_pick: str = "random"):
    """Algorithm 1 end to end: schedule + replay.  Returns (blocks, stats)."""
    schedule, stats = peel_schedule(M, rng=rng, root_pick=root_pick)
    return apply_schedule(schedule, results), stats


def gaussian_decode(M, results):
    """Reference decoder: solve the full linear system with least squares.

    O(K * mn^2 + mn * rt) -- the dense path the paper's hybrid decoder beats.
    pinv(M) is computed on the host in float64; applying it block by block
    keeps sparse CSR blocks sparse.
    """
    M = sp.csr_matrix(M).toarray()
    K, d = M.shape
    if np.linalg.matrix_rank(M) < d:
        raise DecodingError("coefficient matrix not full column rank")
    first = next(b for b in results if b is not None)
    D = np.linalg.pinv(M)
    D[np.abs(D) < 1e-12] = 0.0
    out = []
    for c in range(d):
        acc = None
        for k in range(K):
            if D[c, k] != 0.0:
                term = results[k] * float(D[c, k])
                acc = term if acc is None else acc + term
        out.append(acc if acc is not None else zeros_like_block(first))
    return out


def decode_matrix(M: sp.spmatrix | np.ndarray) -> np.ndarray:
    """D = M^+ in R^{mn x K}: decoding as a single linear combine."""
    M = sp.csr_matrix(M).toarray()
    return np.linalg.pinv(M)
