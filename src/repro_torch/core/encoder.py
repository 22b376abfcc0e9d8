"""Encoder for the (P, S)-sparse code (paper Definition 1).

Block convention: A is split into m column blocks, B into n column blocks;
block (i, j) of C = A^T B is C_ij = A_i^T B_j and maps to flat column index
``col = i * n + j`` of the coefficient matrix M in R^{N x mn}.

Worker k's task is the weighted combination  C~_k = sum_{(i,j)} w^k_ij C_ij
with the number of nonzero weights drawn from a degree distribution P and the
nonzero weight values drawn i.i.d. uniform from the finite set S (paper uses
S = [m^2 n^2]; we default to that and also offer numerically friendlier sets).

A copy of the part of the JAX package's numpy module that the device path
needs: the sampler (same draws from the same seed) and the chunk rule.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from repro_torch.core import degree as degree_lib


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
