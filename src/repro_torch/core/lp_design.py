"""Optimal degree-distribution design (paper Section IV-C, model (46)).

    min   sum_k k p_k                      (average degree = worker overhead)
    s.t.  P(M full rank) > p_c             (surrogate: perfect-matching prob)
          [1 - Omega'(x)/d]^{d+c} <= 1 - x - c0 sqrt((1-x)/d)   on a grid
          p in simplex(d)

The decodability constraint is *linear* in p after rearrangement:

    Omega'(x) >= d * (1 - rhs(x)^{1/(d+c)}),    Omega'(x) = sum_k k p_k x^{k-1}

so with the matching constraint dropped the problem is an LP
(``optimize_degree_distribution(..., method="lp")``).

For the full-rank constraint: the paper's formula (48) is a sequential
approximation that grossly *underestimates* the true matching probability
for d >~ 10 (see repro_torch.core.matching), which would force absurdly dense
designs.  The default method="hybrid" therefore solves the decodability LP
and then *validates* the matching probability by Monte-Carlo, blending the LP
solution toward Wave Soliton (bisection on the blend weight) until the
empirical probability clears p_m -- a numerically honest stand-in for the
paper's Table IV procedure.  method="slsqp" keeps the paper-literal program
(formula (48) as the constraint) for reference.

A copy of the JAX package's numpy module (the same designs from the same
seed).
"""

from __future__ import annotations

import numpy as np
import scipy.optimize as opt

from repro_torch.core.degree import robust_soliton, wave_soliton
from repro_torch.core.matching import empirical_matching_prob, perfect_matching_prob


def _decodability_rows(d: int, c: float, c0: float, b: float, max_degree: int,
                       grid: int = 64):
    """Linear constraint rows:  A @ p >= lo  encoding Omega'(x) >= g(x)."""
    xs = np.linspace(0.0, 1.0 - b / d, grid)
    ks = np.arange(1, max_degree + 1)
    A = ks[None, :] * xs[:, None] ** (ks[None, :] - 1)  # Omega'(x) coefficients
    rhs = 1.0 - xs - c0 * np.sqrt((1.0 - xs) / d)
    rhs = np.clip(rhs, 1e-12, 1.0)
    lo = d * (1.0 - rhs ** (1.0 / (d + c)))
    return A, lo


def optimize_degree_distribution(
    d: int,
    max_degree: int | None = None,
    p_m: float = 0.95,
    c: float = 2.0,
    c0: float = 0.1,
    b: float = 1.0,
    method: str = "hybrid",
    mc_trials: int = 200,
    seed: int = 0,
) -> np.ndarray:
    """Design a degree distribution for mn = d blocks.

    Returns probabilities over degrees 1..d (mass beyond max_degree is zero).
    """
    max_degree = max_degree or min(d, 8)
    A, lo = _decodability_rows(d, c, c0, b, max_degree)
    ks = np.arange(1, max_degree + 1, dtype=np.float64)

    def lift(p_small: np.ndarray) -> np.ndarray:
        p = np.zeros(d)
        p[:max_degree] = p_small
        return p

    if method == "lp":
        # LP: decodability + simplex (+ a floor on p_1 so peeling can start:
        # the matching constraint is dropped, p_1 >= 1/d stands in for it).
        A_ub = -A
        b_ub = -lo
        bounds = [(1.0 / d if k == 0 else 0.0, 1.0) for k in range(max_degree)]
        res = opt.linprog(
            ks, A_ub=A_ub, b_ub=b_ub,
            A_eq=np.ones((1, max_degree)), b_eq=[1.0],
            bounds=bounds, method="highs",
        )
        if not res.success:
            raise RuntimeError(f"LP design infeasible for d={d}: {res.message}")
        return lift(res.x)

    if method == "hybrid":
        base = optimize_degree_distribution(
            d, max_degree=max_degree, c=c, c0=c0, b=b, method="lp"
        )
        wave = wave_soliton(d)
        rng = np.random.default_rng(seed)

        def ok(p):
            return empirical_matching_prob(p, trials=mc_trials,
                                           rng=np.random.default_rng(seed)) >= p_m

        if ok(base):
            return base
        if not ok(wave):
            # Even Wave Soliton misses p_m at this d: return the heavier one.
            return wave
        lo_w, hi_w = 0.0, 1.0  # blend weight toward wave
        for _ in range(8):
            mid = 0.5 * (lo_w + hi_w)
            if ok((1 - mid) * base + mid * wave):
                hi_w = mid
            else:
                lo_w = mid
        return (1 - hi_w) * base + hi_w * wave

    # SLSQP with the paper-literal matching probability formula (48).
    x0 = robust_soliton(d)[:max_degree]
    x0 = x0 / x0.sum()

    cons = [
        {"type": "eq", "fun": lambda p: p.sum() - 1.0},
        {"type": "ineq", "fun": lambda p: A @ p - lo},  # decodability
        {"type": "ineq",
         "fun": lambda p: perfect_matching_prob(lift(np.clip(p, 0, 1))) - p_m},
    ]
    res = opt.minimize(
        lambda p: float(ks @ p),
        x0,
        method="SLSQP",
        bounds=[(0.0, 1.0)] * max_degree,
        constraints=cons,
        options={"maxiter": 300, "ftol": 1e-9},
    )
    if not res.success:
        # Fall back to the LP relaxation rather than failing the pipeline.
        return optimize_degree_distribution(
            d, max_degree=max_degree, p_m=p_m, c=c, c0=c0, b=b, method="lp"
        )
    p = np.clip(res.x, 0.0, None)
    return lift(p / p.sum())
