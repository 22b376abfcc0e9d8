"""Degree distributions for the (P, S)-sparse code.

The degree of a coded task is the number of nonzero weights w_ij in the
linear combination  C~_k = sum_ij w_ij A_i^T B_j.  The paper's central design
is the Wave Soliton distribution (Definition 2): a Soliton distribution capped
at mn with probability mass moved from degree 2 to the tail, giving average
degree Theta(ln(mn)) while keeping enough ripple mass for peeling decoding.

A copy of the JAX package's numpy module (the samplers must draw the very
same degrees from the same seed, so plans match bit for bit).
"""

from __future__ import annotations

import numpy as np

# Normalizing factor tau = 35/18 (paper, Definition 2).  With
#   p_1 = tau/d,  p_2 = tau/70,  p_k = tau/(k(k-1)) for 3 <= k <= d
# the telescoping sum gives  sum_k p_k = tau * (1/70 + 1/2) = 1 exactly.
WAVE_TAU = 35.0 / 18.0


def wave_soliton(d: int) -> np.ndarray:
    """Wave Soliton distribution P_w over degrees 1..d (paper eq. (7))."""
    if d < 3:
        # Degenerate tiny cases: fall back to a proper renormalized cap.
        p = np.zeros(d)
        p[0] = WAVE_TAU / d
        if d >= 2:
            p[1] = WAVE_TAU / 70.0
        return p / p.sum()
    k = np.arange(1, d + 1, dtype=np.float64)
    p = WAVE_TAU / (k * (k - 1.0 + (k == 1)))  # placeholder for k>=3 shape
    p[0] = WAVE_TAU / d
    p[1] = WAVE_TAU / 70.0
    p[2:] = WAVE_TAU / (k[2:] * (k[2:] - 1.0))
    # Exact normalization (analytically sums to 1 + tau/d - tau/d; tiny float
    # residue is folded into the largest mass so sampling is well-defined).
    p /= p.sum()
    return p


def ideal_soliton(d: int) -> np.ndarray:
    """Ideal Soliton: p_1 = 1/d, p_k = 1/(k(k-1))."""
    k = np.arange(1, d + 1, dtype=np.float64)
    p = np.empty(d)
    p[0] = 1.0 / d
    if d > 1:
        p[1:] = 1.0 / (k[1:] * (k[1:] - 1.0))
    return p / p.sum()


def robust_soliton(d: int, c: float = 0.03, delta: float = 0.5) -> np.ndarray:
    """Robust Soliton distribution (Luby, LT codes).

    rho(k) ideal soliton; tau(k) spike at d/R with R = c*ln(d/delta)*sqrt(d).
    """
    rho = ideal_soliton(d)
    R = c * np.log(d / delta) * np.sqrt(d)
    R = max(R, 1.0 + 1e-9)
    spike = int(min(max(round(d / R), 1), d))
    tau = np.zeros(d)
    ks = np.arange(1, spike, dtype=np.float64)
    if spike > 1:
        tau[: spike - 1] = R / (ks * d)
    tau[spike - 1] = R * np.log(R / delta) / d
    p = rho + tau
    return p / p.sum()


# Optimized degree distributions from Table IV of the paper (model (46)).
# Keys are mn; values are the probability masses over degrees 1..6.
TABLE_IV: dict[int, list[float]] = {
    6: [0.0217, 0.9390, 0.0393, 0.0, 0.0, 0.0],
    9: [0.0291, 0.7243, 0.2466, 0.0, 0.0, 0.0],
    12: [0.0598, 0.1639, 0.7056, 0.0707, 0.0, 0.0],
    16: [0.0264, 0.3724, 0.1960, 0.4052, 0.0, 0.0],
    25: [0.0221, 0.4725, 0.1501, 0.0, 0.0, 0.3553],
}


def optimized_distribution(d: int) -> np.ndarray:
    """Paper Table IV distribution when available, else Wave Soliton."""
    if d in TABLE_IV:
        p = np.zeros(d)
        src = TABLE_IV[d][:d]
        p[: len(src)] = src
        return p / p.sum()
    return wave_soliton(d)


def sample_degrees(rng: np.random.Generator, p: np.ndarray, size: int) -> np.ndarray:
    """Draw `size` degrees in 1..len(p) from distribution p."""
    return rng.choice(np.arange(1, len(p) + 1), size=size, p=p)


DISTRIBUTIONS = {
    "wave_soliton": wave_soliton,
    "ideal_soliton": ideal_soliton,
    "robust_soliton": robust_soliton,
    "optimized": optimized_distribution,
}


def get_distribution(name: str, d: int, **kw) -> np.ndarray:
    try:
        fn = DISTRIBUTIONS[name]
    except KeyError as e:
        raise ValueError(f"unknown degree distribution {name!r}; "
                         f"options: {sorted(DISTRIBUTIONS)}") from e
    return fn(d, **kw)


def average_degree(p: np.ndarray) -> float:
    k = np.arange(1, len(p) + 1, dtype=np.float64)
    return float(np.dot(k, p))


def degree_generator_poly(p: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Omega(x) = sum_k p_k x^k (paper eq. (9))."""
    x = np.asarray(x, dtype=np.float64)
    ks = np.arange(1, len(p) + 1)
    return np.sum(p[None, :] * x[..., None] ** ks[None, :], axis=-1)


def degree_generator_dpoly(p: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Omega'(x) = sum_k k p_k x^{k-1}."""
    x = np.asarray(x, dtype=np.float64)
    ks = np.arange(1, len(p) + 1)
    return np.sum(ks[None, :] * p[None, :] * x[..., None] ** (ks[None, :] - 1), axis=-1)
