"""Continuous-batching request scheduler + per-request SLO metrics.

Iteration-level (continuous) batching: the engine calls ``admit`` every
token step, so a finished request's slot is refilled immediately instead of
waiting for the whole batch to drain.  Admission is FIFO *within* a tenant
and round-robin *across* tenants -- one chatty tenant cannot starve the
queue position of another -- with a hard cap of ``max_batch`` requests in
flight.

This module is the port's copy of the JAX package's scheduler, and
deliberately torch-free: scheduling decisions and metric accounting are
pure host logic, testable without an accelerator and reusable against the
simulated or the live executor.  Time is a float the caller supplies, so
the same scheduler runs under a virtual clock in tests and wall clock in
the engine.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict, deque
from typing import Iterable, Optional


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request latency objectives, seconds.  ``inf`` = unconstrained."""

    ttft: float = math.inf        # time to first token
    per_token: float = math.inf   # mean time per output token (TPOT)


@dataclasses.dataclass
class Request:
    """One generation request plus its measured lifecycle."""

    rid: str
    tenant: str
    arrival_time: float
    prompt_len: int
    max_new_tokens: int
    slo: SLO = dataclasses.field(default_factory=SLO)
    prompt_seed: int = 0          # deterministic prompt synthesis

    # -- runtime state, owned by scheduler/engine --
    admitted_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_latencies: list = dataclasses.field(default_factory=list)
    tokens: list = dataclasses.field(default_factory=list)
    straggler_recoveries: int = 0
    error: Optional[str] = None

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token over the decode phase."""
        if not self.token_latencies:
            return None
        return sum(self.token_latencies) / len(self.token_latencies)

    @property
    def completed(self) -> bool:
        return self.finish_time is not None and self.error is None

    def meets_slo(self) -> bool:
        if not self.completed:
            return False
        if self.ttft is not None and self.ttft > self.slo.ttft:
            return False
        tpot = self.tpot
        if tpot is not None and tpot > self.slo.per_token:
            return False
        return True


class ContinuousBatcher:
    """Admission queue with FIFO-within-tenant, round-robin-across-tenants.

    Invariants (test-enforced): ``len(running) <= max_batch`` always; a
    tenant's requests are admitted in submission order; when several
    tenants have waiting requests, consecutive admissions rotate over them.
    """

    def __init__(self, max_batch: int):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self._queues: "OrderedDict[str, deque[Request]]" = OrderedDict()
        self._rr = 0  # rotating tenant pointer, advances per admission
        self.running: list[Request] = []

    def submit(self, req: Request) -> None:
        self._queues.setdefault(req.tenant, deque()).append(req)

    @property
    def waiting(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def waiting_for(self, tenant: str) -> int:
        return len(self._queues.get(tenant, ()))

    def admit(self, now: float) -> list[Request]:
        """Fill free slots; returns the newly admitted requests in order."""
        admitted = []
        while len(self.running) < self.max_batch:
            tenants = [t for t, q in self._queues.items() if q]
            if not tenants:
                break
            tenant = tenants[self._rr % len(tenants)]
            self._rr += 1
            req = self._queues[tenant].popleft()
            req.admitted_time = now
            self.running.append(req)
            admitted.append(req)
        return admitted

    def retire(self, req: Request, now: float) -> None:
        req.finish_time = now
        self.running.remove(req)


def percentile(values: Iterable[float], p: float) -> float:
    """Linear-interpolation percentile (numpy semantics, stdlib-only)."""
    vals = sorted(values)
    if not vals:
        return math.nan
    if len(vals) == 1:
        return float(vals[0])
    rank = (p / 100.0) * (len(vals) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(vals) - 1)
    frac = rank - lo
    return float(vals[lo] * (1.0 - frac) + vals[hi] * frac)


class ServingMetrics:
    """Aggregates finished requests into the bench's serving schema."""

    def __init__(self):
        self.requests: list[Request] = []

    def record(self, req: Request) -> None:
        self.requests.append(req)

    def summary(self) -> dict:
        """The JAX package's ``serving`` bench schema: latencies
        in milliseconds, SLO attainment over ALL finished requests (a
        failed request is an SLO miss, not a dropped sample)."""
        completed = [r for r in self.requests if r.completed]
        failed = [r for r in self.requests if not r.completed]
        token_lat = [lat for r in completed for lat in r.token_latencies]
        ttfts = [r.ttft for r in completed if r.ttft is not None]
        n = len(self.requests)
        by_tenant: dict[str, int] = {}
        for r in self.requests:
            by_tenant[r.tenant] = by_tenant.get(r.tenant, 0) + 1
        return {
            "requests": n,
            "completed": len(completed),
            "failed": len(failed),
            "by_tenant": by_tenant,
            "tokens": sum(len(r.tokens) for r in completed),
            "ttft_p50_ms": percentile(ttfts, 50) * 1e3 if ttfts else None,
            "ttft_p95_ms": percentile(ttfts, 95) * 1e3 if ttfts else None,
            "token_p50_ms": percentile(token_lat, 50) * 1e3 if token_lat else None,
            "token_p95_ms": percentile(token_lat, 95) * 1e3 if token_lat else None,
            "token_p99_ms": percentile(token_lat, 99) * 1e3 if token_lat else None,
            "slo_attainment": (sum(r.meets_slo() for r in self.requests) / n
                               if n else None),
            "straggler_recoveries": sum(r.straggler_recoveries
                                        for r in self.requests),
        }
