"""The coded-computation schemes, as generator matrices in the block domain.

Every scheme is expressed in the *block domain*: the mn block products
C_ij = A_i^T B_j are the unknowns, a worker's results are rows of a generator
matrix M applied to them.  For sum-of-products codes (sparse code, LT, sparse
MDS) a worker's cost factor equals its row degree; for
product-of-coded-matrices codes (polynomial, MDS, product code) the coded
inputs densify m- and n-fold, so the single product costs ~m*n uncoded
block products (paper Fig. 1, Table I).

A copy of the JAX package's builders (same draws from the same seed, so
the registry builds the same plans) and of its host decode policy
(``CodeInstance.decode``/``can_decode``, the chunk-granular ``ChunkedCode``),
decoding torch blocks on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from repro_torch.core import degree as degree_lib
from repro_torch.core.decoder import (
    DecodingError,
    apply_schedule,
    gaussian_decode,
    hybrid_decode,
    peel_schedule,
)
from repro_torch.core.encoder import (
    SparseCodeSpec,
    chunk_expand,
    generate_coefficient_matrix,
)


@dataclasses.dataclass(frozen=True)
class SchemeInvariants:
    """Static decodability profile of a scheme design.

    optimal_workers -- the information-theoretic minimum worker count whose
        results decode: ``"mn"``, ``"m"`` (the MDS-on-A code) or ``"all"``
        (uncoded: every worker is critical).
    exact -- worst-case recovery threshold EQUALS the optimum.
    mean_overhead / max_overhead -- for non-exact designs, the allowed
        empirical recovery overhead beyond the optimum, as a fraction of it.
    dense_rows -- generator rows are dense (row weight ~ mn).
    cond_warn -- condition-number budget for worst-case survivor subsets of
        the device plan's coefficient matrix; the config layer budgets
        quantized tiles against it.
    """

    optimal_workers: str = "mn"
    exact: bool = False
    mean_overhead: float = 0.5
    max_overhead: float = 1.0
    dense_rows: bool = False
    cond_warn: float = 1e8

    def __post_init__(self):
        if self.optimal_workers not in ("mn", "m", "all"):
            raise ValueError(
                f"optimal_workers must be mn|m|all, got "
                f"{self.optimal_workers!r}")


#: per-scheme profiles, keyed by registry name (the registry wires these
#: onto the ``Scheme`` entries at registration)
INVARIANTS: dict[str, SchemeInvariants] = {
    "uncoded": SchemeInvariants(optimal_workers="all", exact=True,
                                mean_overhead=0.0, max_overhead=0.0),
    "sparse_code": SchemeInvariants(mean_overhead=0.30, max_overhead=0.80),
    "lt_code": SchemeInvariants(mean_overhead=0.80, max_overhead=1.60),
    "sparse_mds": SchemeInvariants(mean_overhead=0.30, max_overhead=0.80),
    "polynomial": SchemeInvariants(exact=True, mean_overhead=0.0,
                                   max_overhead=0.0, dense_rows=True),
    "mds": SchemeInvariants(optimal_workers="m", exact=True,
                            mean_overhead=0.0, max_overhead=0.0,
                            dense_rows=True),
    "product": SchemeInvariants(mean_overhead=0.80, max_overhead=1.60,
                                dense_rows=True, cond_warn=1e11),
}


@dataclasses.dataclass
class CodeInstance:
    """A realized code: worker -> generator rows, costs, decode policy."""

    name: str
    M: sp.csr_matrix                 # (R, mn) generator in the block domain
    worker_rows: list[list[int]]     # worker k owns these rows of M
    cost_factor: np.ndarray          # (N,) local compute vs one block product
    decode_kind: str                 # "hybrid" | "peel" | "dense"

    @property
    def num_workers(self) -> int:
        return len(self.worker_rows)

    @property
    def mn(self) -> int:
        return self.M.shape[1]

    def rows_of(self, workers: list[int]) -> list[int]:
        return [r for w in workers for r in self.worker_rows[w]]

    def can_decode(self, workers: list[int]) -> bool:
        return _can_decode_rows(self.decode_kind, self.mn,
                                self.M[self.rows_of(workers)])

    def decode(self, workers: list[int], results_by_row: dict[int, object]):
        rows = self.rows_of(workers)
        sub = self.M[rows]
        data = [results_by_row[r] for r in rows]
        return _decode_rows(self.decode_kind, sub, data)

    def chunked(self, num_chunks: int) -> "ChunkedCode":
        """Chunk-granular view of this code (partial-straggler protocol).

        Every worker's task splits into ``num_chunks`` ordered sub-tasks;
        each sub-task is one row of the chunk-expanded coefficient matrix,
        so the master can decode from completed *chunks* instead of whole
        tasks.  ``num_chunks == 1`` is the atomic protocol, bit-for-bit.
        """
        return ChunkedCode(base=self, num_chunks=num_chunks,
                           M=chunk_expand(self.M, num_chunks))


def _decode_rows(decode_kind: str, sub: sp.csr_matrix, data: list):
    """Decode collected rows with a CodeInstance decode policy."""
    if decode_kind == "hybrid":
        blocks, _ = hybrid_decode(sub, data)
        return blocks
    if decode_kind == "peel":
        sched, _ = peel_schedule(sub, check_rank=False, root_pick="fail")
        return apply_schedule(sched, data)
    return gaussian_decode(sub, data)


def _can_decode_rows(decode_kind: str, mn: int, sub: sp.csr_matrix) -> bool:
    """Decodability of collected rows under a CodeInstance decode policy --
    the one place the rule lives, shared by the atomic and chunked views."""
    if sub.shape[0] < mn:
        return False
    if decode_kind == "peel":
        try:
            peel_schedule(sub, check_rank=False, root_pick="fail")
            return True
        except (DecodingError, ValueError):
            return False
    return np.linalg.matrix_rank(sub.toarray()) == mn


@dataclasses.dataclass
class ChunkedCode:
    """Chunk-granular view of a ``CodeInstance``.

    Identifiers are ``(worker, chunk)`` pairs: worker w's chunk c stands for
    the c-th ordered sub-task of EACH of w's generator rows.  The expanded
    matrix M has row ``r * num_chunks + c`` = chunk c of base row r (see
    ``encoder.chunk_expand``); ``rows_of``/``can_decode``/``decode`` mirror
    the ``CodeInstance`` API but consume (worker, chunk) ids, and
    ``chunk_work`` exposes the per-chunk share of each worker's cost factor
    so straggler models can place partial progress on the timeline.
    """

    base: CodeInstance
    num_chunks: int
    M: sp.csr_matrix          # (R * num_chunks, mn) chunk-expanded generator

    @property
    def name(self) -> str:
        q = self.num_chunks
        return self.base.name if q == 1 else f"{self.base.name}/q{q}"

    @property
    def num_workers(self) -> int:
        return self.base.num_workers

    @property
    def mn(self) -> int:
        return self.base.mn

    def expanded_rows(self, worker: int, chunk: int) -> list[int]:
        """Nonempty expanded-M rows delivered by (worker, chunk)."""
        q = self.num_chunks
        rows = [r * q + chunk for r in self.base.worker_rows[worker]]
        return [r for r in rows if self.M.indptr[r + 1] > self.M.indptr[r]]

    def rows_of(self, pairs) -> list[int]:
        """Expanded-M rows of the given (worker, chunk) arrivals, in order."""
        return [r for w, c in pairs for r in self.expanded_rows(w, c)]

    def chunk_work(self) -> np.ndarray:
        """(N, num_chunks) nominal work per chunk, in block-product units.

        Worker w's cost factor is split across its chunks proportionally to
        the slots each chunk carries (summed over the worker's rows), so the
        per-worker total equals the atomic cost exactly.
        """
        q = self.num_chunks
        N = self.num_workers
        work = np.zeros((N, q))
        nnz_exp = np.diff(self.M.indptr)              # per expanded row
        for w in range(N):
            slots = np.zeros(q)
            for r in self.base.worker_rows[w]:
                slots += nnz_exp[r * q:(r + 1) * q]
            total = slots.sum()
            if total > 0:
                work[w] = self.base.cost_factor[w] * slots / total
        return work

    def can_decode(self, pairs) -> bool:
        return _can_decode_rows(self.base.decode_kind, self.mn,
                                self.M[self.rows_of(pairs)])

    def decode(self, pairs, results_by_row: dict[int, object]):
        """Decode from chunk results (keyed by expanded-M row id)."""
        rows = self.rows_of(pairs)
        sub = self.M[rows]
        data = [results_by_row[r] for r in rows]
        return _decode_rows(self.base.decode_kind, sub, data)


def uncoded(m: int, n: int) -> CodeInstance:
    """Each of mn workers computes one block; master waits for all."""
    d = m * n
    return CodeInstance(
        name="uncoded",
        M=sp.identity(d, format="csr"),
        worker_rows=[[k] for k in range(d)],
        cost_factor=np.ones(d),
        decode_kind="dense",  # identity: decode is a no-op relabel
    )


def sparse_code(
    m: int, n: int, N: int, distribution: str = "wave_soliton",
    weight_kind: str = "paper", seed: int = 0,
) -> CodeInstance:
    """The paper's (P, S)-sparse code."""
    spec = SparseCodeSpec(m=m, n=n, num_workers=N, distribution=distribution,
                          weight_kind=weight_kind, seed=seed)
    M = generate_coefficient_matrix(spec)
    deg = np.diff(M.indptr)
    return CodeInstance(
        name=f"sparse_code[{distribution}]",
        M=M,
        worker_rows=[[k] for k in range(N)],
        cost_factor=deg.astype(np.float64),
        decode_kind="hybrid",
    )


def lt_code(m: int, n: int, N: int, seed: int = 0) -> CodeInstance:
    """LT code: Robust Soliton degrees, unit weights, peeling-only decode."""
    d = m * n
    rng = np.random.default_rng(seed)
    probs = degree_lib.robust_soliton(d)
    rows, cols, vals = [], [], []
    for k in range(N):
        deg = int(degree_lib.sample_degrees(rng, probs, 1)[0])
        chosen = rng.choice(d, size=deg, replace=False)
        rows.extend([k] * deg)
        cols.extend(chosen.tolist())
        vals.extend([1.0] * deg)
    M = sp.csr_matrix((vals, (rows, cols)), shape=(N, d))
    deg = np.diff(M.indptr)
    return CodeInstance(
        name="lt_code",
        M=M,
        worker_rows=[[k] for k in range(N)],
        cost_factor=deg.astype(np.float64),
        decode_kind="peel",
    )


def sparse_mds_code(m: int, n: int, N: int, alpha: float = 2.0, seed: int = 0) -> CodeInstance:
    """Sparse MDS [14]: Bernoulli(alpha*ln(d)/d) generator, Gaussian decode."""
    d = m * n
    rng = np.random.default_rng(seed)
    p = min(1.0, alpha * np.log(max(d, 2)) / d)
    mask = rng.random((N, d)) < p
    # Guarantee no empty rows (a worker with nothing to do is useless).
    for k in range(N):
        if not mask[k].any():
            mask[k, rng.integers(d)] = True
    vals = rng.standard_normal((N, d)) * mask
    M = sp.csr_matrix(vals)
    deg = np.diff(M.indptr)
    return CodeInstance(
        name="sparse_mds",
        M=M,
        worker_rows=[[k] for k in range(N)],
        cost_factor=deg.astype(np.float64),
        decode_kind="dense",
    )


def polynomial_code(m: int, n: int, N: int, seed: int = 0) -> CodeInstance:
    """Polynomial code [7]: worker k computes (sum_i A_i x^i)^T (sum_j B_j x^{jm}).

    Block-domain weight: M[k, i*n+j] = x_k^{i + j*m}.  Evaluation points are
    Chebyshev nodes in [-1, 1] for f64 conditioning.
    """
    d = m * n
    x = np.cos(np.pi * (2 * np.arange(1, N + 1) - 1) / (2 * N))  # distinct
    i_idx, j_idx = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
    expo = (i_idx + j_idx * m).reshape(-1)  # flat col i*n+j
    M = np.power(x[:, None], expo[None, :])
    return CodeInstance(
        name="polynomial",
        M=sp.csr_matrix(M),
        worker_rows=[[k] for k in range(N)],
        cost_factor=np.full(N, float(m * n)),  # coded inputs densify m*n-fold
        decode_kind="dense",
    )


def mds_code(m: int, n: int, N: int, seed: int = 0) -> CodeInstance:
    """(N, m) MDS on A only [5]: worker u computes A~_u^T B (all of B).

    Block domain: worker u owns n rows; row (u, j) has weights G[u, i] on
    blocks (i, j).  Decodable from any m workers.  It has no device plan
    (several generator rows per worker).
    """
    d = m * n
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((N, m))
    rows, cols, vals = [], [], []
    worker_rows = []
    r = 0
    for u in range(N):
        mine = []
        for j in range(n):
            for i in range(m):
                rows.append(r)
                cols.append(i * n + j)
                vals.append(G[u, i])
            mine.append(r)
            r += 1
        worker_rows.append(mine)
    M = sp.csr_matrix((vals, (rows, cols)), shape=(r, d))
    return CodeInstance(
        name="mds",
        M=M,
        worker_rows=worker_rows,
        cost_factor=np.full(N, float(m * n)),  # dense-coded A against full B
        decode_kind="dense",
    )


def product_code(m: int, n: int, N: int, seed: int = 0) -> CodeInstance:
    """Product code [9]: grid of workers, MDS-coded along each input.

    Worker (u, v) computes A~_u^T B~_v with A~ = sum_i G[u,i] A_i and
    B~ = sum_j H[v,j] B_j, so M = G (x) H (Kronecker).  Grid dimensions are
    the largest (mu, nv) with mu*nv <= N, mu >= m, nv >= n.
    """
    rng = np.random.default_rng(seed)
    mu = max(m, int(np.floor(np.sqrt(N * m / n))))
    nv = max(n, N // mu)
    while mu * nv > N and mu > m:
        mu -= 1
        nv = max(n, N // mu)
    G = rng.standard_normal((mu, m))
    H = rng.standard_normal((nv, n))
    M = np.kron(G, H)  # rows ordered (u, v) -> u * nv + v; cols (i, j) -> i*n+j
    num = mu * nv
    return CodeInstance(
        name="product",
        M=sp.csr_matrix(M),
        worker_rows=[[k] for k in range(num)],
        cost_factor=np.full(num, float(m * n)),
        decode_kind="dense",
    )
