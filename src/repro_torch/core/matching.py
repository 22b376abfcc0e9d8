"""Perfect-matching probability of the random balanced bipartite graph.

Paper Appendix D, equations (48)-(49): for G(V1, V2, P) with |V1| = |V2| = d
and right-node degrees drawn from P, the probability that G contains a
perfect matching factorizes (under the sequential-matching argument) as

    P(match) = prod_{s=1..d} (1 - p_0^(s)),

where P^(s) is the "degree evolution": p_k^(s) = probability a right node has
exactly k neighbours inside a fixed subset of V1 of size s, computed by the
downward recursion (49):

    p_k^(s) = p_k^(s+1) * (1 - k/(s+1)) + p_{k+1}^(s+1) * (k+1)/(s+1).

This quantity lower-bounds the full-rank probability of the coefficient
matrix M via Schwartz-Zippel (paper Section IV-A) and is the tractable
surrogate used by the LP design (Section IV-C).

A copy of the JAX package's numpy module (the same designs from the same
seed).
"""

from __future__ import annotations

import numpy as np


def degree_evolution(p: np.ndarray) -> np.ndarray:
    """All P^(s) for s = d..1.

    Input: p over degrees 1..d (paper's P, with implicit p_0 = 0).
    Returns array E of shape (d+1, d+1): E[s, k] = p_k^(s), rows s=0..d.
    """
    d = len(p)
    E = np.zeros((d + 1, d + 1))
    E[d, 1 : d + 1] = p  # P^(d) = P, p_0^(d) = 0
    for s in range(d - 1, -1, -1):
        k = np.arange(0, s + 1)
        # p_k^(s) = p_k^(s+1) (1 - k/(s+1)) + p_{k+1}^(s+1) (k+1)/(s+1)
        E[s, : s + 1] = E[s + 1, : s + 1] * (1.0 - k / (s + 1.0)) + E[
            s + 1, 1 : s + 2
        ] * ((k + 1.0) / (s + 1.0))
    return E


def perfect_matching_prob(p: np.ndarray) -> float:
    """P(G(V1,V2,P) contains a perfect matching), paper eq. (48).

    REPRODUCTION FINDING (see EXPERIMENTS.md): the paper presents (48) as an
    "exact formula", but it is a *sequential greedy* factorization -- it
    treats "vertex v_s has a neighbour among the s remaining left vertices"
    as independent events under the unconditioned degree evolution, and a
    greedy failure as a global failure.  Monte-Carlo (``
    empirical_matching_prob``) shows (48) underestimates badly as d grows
    (e.g. Wave Soliton d=16: (48) gives 0.02, truth is ~0.80).  We keep (48)
    verbatim for fidelity and use the Monte-Carlo estimate where an accurate
    value matters (LP design validation).
    """
    E = degree_evolution(np.asarray(p, dtype=np.float64))
    d = len(p)
    probs = 1.0 - E[1 : d + 1, 0]  # (1 - p_0^(s)) for s = 1..d
    return float(np.prod(probs))


def empirical_matching_prob(
    p: np.ndarray, trials: int = 200, rng: np.random.Generator | None = None
) -> float:
    """Monte-Carlo estimate via maximum bipartite matching (validation)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import maximum_bipartite_matching

    rng = rng or np.random.default_rng(0)
    d = len(p)
    degrees = np.arange(1, d + 1)
    hits = 0
    for _ in range(trials):
        rows, cols = [], []
        for v in range(d):
            deg = rng.choice(degrees, p=p)
            nbrs = rng.choice(d, size=deg, replace=False)
            rows.extend([v] * deg)
            cols.extend(nbrs.tolist())
        G = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(d, d))
        match = maximum_bipartite_matching(G, perm_type="column")
        hits += int((match >= 0).all())
    return hits / trials
