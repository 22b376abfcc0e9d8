"""Straggler models for the distributed runtime.

The paper's experimental protocol (Section V): "randomly pick s workers that
are running a background thread which increases the computation time."  That
is ``SlowWorkers(s, slowdown)``.  The tail-at-scale literature motivates the
exponential / shifted-exponential variants used in the coded-computation
analyses [4]-[8].

Two model families (DESIGN.md section 8):

* **Completion-time models** (the historical API): ``completion_times``
  maps each worker's nominal work to one finish time.  Under the chunked
  protocol partial progress still needs a timeline, so the base class
  adapts these to chunks by spreading the drawn total linearly across the
  worker's chunk work -- i.e. the historical models are implicitly
  constant-rate within a job.
* **Rate models** (``RateModel``): each worker serves work at a per-job
  service rate (work units per second), which makes partial progress
  well-defined by construction: chunk c completes at
  ``cumsum(work)[c] / rate``.  ``completion_times`` is derived from the
  same rates, so rate models plug into every pre-chunk call site
  unchanged -- the adapter works in both directions.

A copy of the JAX package's numpy module: the same draws from the same rng,
so a seeded simulation gives the reference's timeline bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class StragglerModel:
    """Multiplier/addend applied to each worker's nominal compute time."""

    def completion_times(self, nominal: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    def chunk_completion_times(
        self, work: np.ndarray, rng: np.random.Generator
    ) -> np.ndarray:
        """(N, q) times at which each worker finishes its c-th ordered chunk.

        ``work``: (N, q) nominal per-chunk work (e.g. ``ChunkedCode.
        chunk_work`` scaled by the unit block time).  Base-class adapter for
        completion-time models: draw the per-worker total with
        ``completion_times`` (same rng consumption as an atomic run, so
        seeded simulations agree), then place chunk finishes at the
        work-proportional fractions of that total -- constant service rate
        within the job.  Rows are nondecreasing by construction.
        """
        work = np.asarray(work, dtype=np.float64)
        if work.ndim != 2:
            raise ValueError(f"work must be (N, q), got shape {work.shape}")
        totals_work = work.sum(axis=1)
        totals_time = np.asarray(
            self.completion_times(totals_work, rng), dtype=np.float64)
        frac = np.cumsum(work, axis=1)
        safe = np.maximum(totals_work, 1e-300)[:, None]
        return totals_time[:, None] * (frac / safe)


@dataclasses.dataclass
class NoStragglers(StragglerModel):
    def completion_times(self, nominal, rng):
        return np.asarray(nominal, dtype=np.float64)


@dataclasses.dataclass
class SlowWorkers(StragglerModel):
    """Paper's model: s uniformly random workers slowed by a factor."""

    num_slow: int
    slowdown: float = 5.0

    def completion_times(self, nominal, rng):
        t = np.asarray(nominal, dtype=np.float64).copy()
        n = len(t)
        s = min(self.num_slow, n)
        idx = rng.choice(n, size=s, replace=False)
        t[idx] *= self.slowdown
        return t


@dataclasses.dataclass
class ExponentialStragglers(StragglerModel):
    """t_k = nominal_k * (1 + Exp(scale)): heavy right tail on every worker."""

    scale: float = 0.5

    def completion_times(self, nominal, rng):
        t = np.asarray(nominal, dtype=np.float64)
        return t * (1.0 + rng.exponential(self.scale, size=len(t)))


@dataclasses.dataclass
class ShiftedExponential(StragglerModel):
    """Classic coded-computation model: t_k = nominal_k + Exp(scale * nominal_k)."""

    scale: float = 1.0

    def completion_times(self, nominal, rng):
        t = np.asarray(nominal, dtype=np.float64)
        return t + rng.exponential(self.scale * np.maximum(t, 1e-12))


# ------------------------------- rate models --------------------------------

class RateModel(StragglerModel):
    """Per-worker service rates: worker k serves ``rate_k`` work units/sec.

    Subclasses implement ``service_rates``; both APIs derive from it:

    * ``completion_times(nominal) = nominal / rates`` (legacy adapter), and
    * ``chunk_completion_times(work) = cumsum(work, axis=1) / rates`` --
      exact partial progress, no linear-spreading approximation needed.

    Rates are drawn once per call from the SAME rng draw, so a rate model
    used through either API describes one consistent straggler realization.
    """

    def service_rates(self, num_workers: int, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError

    def completion_times(self, nominal, rng):
        nominal = np.asarray(nominal, dtype=np.float64)
        rates = np.asarray(
            self.service_rates(len(nominal), rng), dtype=np.float64)
        return nominal / np.maximum(rates, 1e-300)

    def chunk_completion_times(self, work, rng):
        work = np.asarray(work, dtype=np.float64)
        if work.ndim != 2:
            raise ValueError(f"work must be (N, q), got shape {work.shape}")
        rates = np.asarray(
            self.service_rates(work.shape[0], rng), dtype=np.float64)
        return np.cumsum(work, axis=1) / np.maximum(rates, 1e-300)[:, None]


@dataclasses.dataclass
class SlowWorkerRates(RateModel):
    """Rate-domain twin of ``SlowWorkers``: s random workers at rate
    1/slowdown, the rest at rate 1.  Identical marginal completion times,
    but phrased as rates so chunk progress is defined without adaptation."""

    num_slow: int
    slowdown: float = 5.0

    def service_rates(self, num_workers, rng):
        rates = np.ones(num_workers)
        s = min(self.num_slow, num_workers)
        idx = rng.choice(num_workers, size=s, replace=False)
        rates[idx] = 1.0 / self.slowdown
        return rates


@dataclasses.dataclass
class LogNormalRates(RateModel):
    """Every worker's rate ~ LogNormal(0, sigma), median 1: the smooth
    heavy-tail regime where *every* worker makes partial progress worth
    harvesting (no worker is cleanly "slow" or "fast")."""

    sigma: float = 0.5

    def service_rates(self, num_workers, rng):
        return np.exp(rng.normal(0.0, self.sigma, size=num_workers))
