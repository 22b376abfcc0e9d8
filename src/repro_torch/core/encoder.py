"""Encoder for the (P, S)-sparse code (paper Definition 1).

Block convention: A is split into m column blocks, B into n column blocks;
block (i, j) of C = A^T B is C_ij = A_i^T B_j and maps to flat column index
``col = i * n + j`` of the coefficient matrix M in R^{N x mn}.

Worker k's task is the weighted combination  C~_k = sum_{(i,j)} w^k_ij C_ij
with the number of nonzero weights drawn from a degree distribution P and the
nonzero weight values drawn i.i.d. uniform from the finite set S (paper uses
S = [m^2 n^2]; we default to that and also offer numerically friendlier sets).

A copy of the JAX package's numpy module (the same draws from the same
seed, the same chunk rule and task tables), except that blocks are torch
tensors, dense or sparse CSR, on any device (``repro_torch.core.blocks``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import scipy.sparse as sp

from repro_torch.core import degree as degree_lib
from repro_torch.core.blocks import is_csr, split_columns, transposed


def block_col(i: int, j: int, n: int) -> int:
    return i * n + j


def chunk_slices(length: int, num_chunks: int) -> list[slice]:
    """Balanced ordered split of ``range(length)`` into ``num_chunks`` slices.

    The first ``length % num_chunks`` chunks get one extra element; chunks
    beyond ``length`` are empty.  This is THE chunk boundary rule -- the host
    task model, the chunk-expanded coefficient matrix, and the device
    per-chunk survivor masks all call it, so a "chunk" means the same slot
    range everywhere.
    """
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    base, extra = divmod(length, num_chunks)
    out, lo = [], 0
    for c in range(num_chunks):
        hi = lo + base + (1 if c < extra else 0)
        out.append(slice(lo, hi))
        lo = hi
    return out


def col_block(col: int, n: int) -> tuple[int, int]:
    return col // n, col % n


def make_weight_set(m: int, n: int, kind: str = "paper") -> np.ndarray:
    """The finite set S from which nonzero weights are drawn.

    kind="paper":       S = {1, ..., m^2 n^2}  (Definition 1)
    kind="symmetric":   S = {±1, ..., ±ceil(m^2n^2/2)}  (better f32 conditioning,
                        same Schwartz-Zippel guarantee: |S| >= (mn)^2 = deg(det)^2)
    kind="unit":        S = {+1, -1} (binary-ish; NOT S-Z safe, for ablations)
    """
    d2 = (m * n) ** 2
    if kind == "paper":
        return np.arange(1, d2 + 1, dtype=np.float64)
    if kind == "symmetric":
        half = (d2 + 1) // 2
        vals = np.arange(1, half + 1, dtype=np.float64)
        return np.concatenate([vals, -vals])
    if kind == "unit":
        return np.array([1.0, -1.0])
    raise ValueError(f"unknown weight set kind {kind!r}")


@dataclasses.dataclass(frozen=True)
class SparseCodeSpec:
    """Static description of a (P, S)-sparse code instance."""

    m: int
    n: int
    num_workers: int
    distribution: str = "wave_soliton"
    weight_kind: str = "paper"
    seed: int = 0

    @property
    def mn(self) -> int:
        return self.m * self.n

    def degree_probs(self) -> np.ndarray:
        return degree_lib.get_distribution(self.distribution, self.mn)


@dataclasses.dataclass(frozen=True)
class CodedTask:
    """One worker's assignment: which blocks, with which weights."""

    worker: int
    cols: np.ndarray     # flat block indices, shape (degree,)
    weights: np.ndarray  # same shape

    #: chunk index within the worker's ordered sub-task stream (None = the
    #: whole task; set by ``chunks()``)
    chunk: int | None = None

    @property
    def degree(self) -> int:
        return len(self.cols)

    def pairs(self, n: int) -> list[tuple[int, int, float]]:
        return [(c // n, c % n, float(w)) for c, w in zip(self.cols, self.weights)]

    def chunks(self, num_chunks: int) -> list["CodedTask"]:
        """Ordered chunk decomposition of this task (partial-straggler model).

        The slot list is split into ``num_chunks`` contiguous sub-tasks via
        ``chunk_slices``; sub-task c computes the partial combination over its
        slots, so the full task result is the (ordered) sum of its chunk
        results.  Chunks past the degree are empty tasks (zero contribution).
        """
        return [
            CodedTask(worker=self.worker, cols=self.cols[sl],
                      weights=self.weights[sl], chunk=c)
            for c, sl in enumerate(chunk_slices(self.degree, num_chunks))
        ]


def generate_coefficient_matrix(
    spec: SparseCodeSpec, rng: np.random.Generator | None = None
) -> sp.csr_matrix:
    """Sample the coefficient matrix M in R^{N x mn} per Definition 1."""
    rng = rng or np.random.default_rng(spec.seed)
    d = spec.mn
    probs = spec.degree_probs()
    S = make_weight_set(spec.m, spec.n, spec.weight_kind)
    degrees = degree_lib.sample_degrees(rng, probs, spec.num_workers)
    rows, cols, vals = [], [], []
    for k in range(spec.num_workers):
        deg = int(degrees[k])
        chosen = rng.choice(d, size=deg, replace=False)
        w = rng.choice(S, size=deg)
        rows.extend([k] * deg)
        cols.extend(chosen.tolist())
        vals.extend(w.tolist())
    M = sp.csr_matrix(
        (np.asarray(vals, dtype=np.float64), (rows, cols)),
        shape=(spec.num_workers, d),
    )
    return M


def chunk_expand(M: sp.spmatrix, num_chunks: int) -> sp.csr_matrix:
    """Chunk-expanded coefficient matrix: row r splits into ``num_chunks``
    ordered chunk rows.

    Expanded row ``r * num_chunks + c`` carries the slots of chunk c of row r
    (``chunk_slices`` over the row's nonzero slot list, CSR order).  Summing a
    row's chunk rows reproduces the original row exactly (disjoint supports),
    so every completed *chunk* is one usable equation over the mn unknown
    blocks, which is what lets the master decode from partial stragglers.
    ``num_chunks == 1`` returns M itself (same sparsity, same values).
    """
    M = sp.csr_matrix(M)
    if num_chunks == 1:
        return M
    R, d = M.shape
    rows, cols, vals = [], [], []
    for r in range(R):
        lo, hi = M.indptr[r], M.indptr[r + 1]
        for c, sl in enumerate(chunk_slices(hi - lo, num_chunks)):
            idx = M.indices[lo + sl.start:lo + sl.stop]
            rows.extend([r * num_chunks + c] * len(idx))
            cols.extend(idx.tolist())
            vals.extend(M.data[lo + sl.start:lo + sl.stop].tolist())
    return sp.csr_matrix(
        (np.asarray(vals, dtype=M.dtype), (rows, cols)),
        shape=(R * num_chunks, d))


def make_tasks(M: sp.csr_matrix) -> list[CodedTask]:
    """Turn rows of the coefficient matrix into per-worker tasks."""
    tasks = []
    for k in range(M.shape[0]):
        lo, hi = M.indptr[k], M.indptr[k + 1]
        tasks.append(
            CodedTask(worker=k, cols=M.indices[lo:hi].copy(), weights=M.data[lo:hi].copy())
        )
    return tasks


def split_blocks(X, parts: int, axis: int = 1) -> list:
    """Evenly split a matrix into `parts` blocks along `axis` (pads nothing;
    requires divisibility, as in the paper's setup).

    numpy arrays, scipy matrices and dense tensors are sliced; a sparse CSR
    tensor (which torch cannot slice) is split on its indices, along
    columns only.
    """
    size = X.shape[axis]
    if size % parts:
        raise ValueError(f"dimension {size} not divisible into {parts} blocks")
    if is_csr(X):
        if axis != 1:
            raise ValueError("a sparse CSR tensor splits along its columns only")
        return split_columns(X, parts)
    step = size // parts
    out = []
    for p in range(parts):
        sl = slice(p * step, (p + 1) * step)
        out.append(X[:, sl] if axis == 1 else X[sl, :])
    return out


def compute_block_products(
    A_blocks: Sequence, B_blocks: Sequence
) -> list[list]:
    """All mn uncoded block products C_ij = A_i^T B_j (oracle/test helper)."""
    return [[(transposed(Ai) @ Bj) for Bj in B_blocks] for Ai in A_blocks]


def encode_blocks(task: CodedTask, A_blocks: Sequence, B_blocks: Sequence, n: int):
    """Execute one coded task: C~ = sum w_ij A_i^T B_j.

    Works for dense and sparse CSR tensors alike (a CSR product stays CSR).
    The sum is evaluated product-by-product (the combination does not
    factorize), which is exactly why the paper's per-worker overhead is
    `degree x` one block product, i.e. Theta(ln(mn)) on average under Wave
    Soliton.  A sparse CSR block of A must come as a ``blocks.HeldA``,
    whose transpose was made once (the runtime holds A's blocks so).
    """
    acc = None
    for c, w in zip(task.cols, task.weights):
        i, j = c // n, c % n
        term = (transposed(A_blocks[i]) @ B_blocks[j]) * float(w)
        acc = term if acc is None else acc + term
    return acc
