"""Load generation: Poisson open-loop traces and closed-loop clients.

The port's copy of the JAX package's load generator: torch-free and
deterministic: a ``(seed, tenant mix)`` pair always yields the same trace,
so serving benchmarks are reproducible and tests can assert on exact
arrival sequences.

Two standard load models:

- ``poisson_trace``: open loop.  Each tenant submits with exponential
  inter-arrival times at its own rate, regardless of completions -- the
  model behind "p99 under load" numbers, since queueing delay compounds
  when the server falls behind.
- ``ClosedLoopLoad``: each of ``concurrency`` virtual clients keeps
  exactly one request outstanding; the caller feeds completions back via
  ``next_request``.  Measures capability (peak throughput), not tail
  behaviour under overload.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional

from repro_torch.serving.scheduler import SLO, Request


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic class in the mix."""

    name: str
    rate: float                   # requests/second (open loop)
    prompt_len: int = 8
    max_new_tokens: int = 4
    slo: SLO = dataclasses.field(default_factory=SLO)
    weight: float = 1.0           # closed loop: share of clients


def poisson_trace(tenants: list[TenantSpec], *, horizon: float,
                  seed: int = 0, max_requests: Optional[int] = None,
                  ) -> list[Request]:
    """Open-loop Poisson arrivals per tenant, merged and sorted by time.

    Each tenant gets an independent exponential inter-arrival stream
    (rate ``t.rate``) from its own sub-seed, so adding a tenant to the mix
    never perturbs another tenant's arrivals.
    """
    if horizon <= 0:
        raise ValueError(f"horizon must be > 0, got {horizon}")
    reqs: list[Request] = []
    for ti, t in enumerate(tenants):
        if t.rate <= 0:
            raise ValueError(f"tenant {t.name!r}: rate must be > 0, got {t.rate}")
        # string seeds hash via sha512 (stable across processes); a tuple
        # seed would go through PYTHONHASHSEED-salted hashing and vary
        rng = random.Random(f"{seed}:{t.name}")
        now, k = 0.0, 0
        while True:
            now += rng.expovariate(t.rate)
            if now >= horizon:
                break
            reqs.append(Request(
                rid=f"{t.name}-{k}", tenant=t.name, arrival_time=now,
                prompt_len=t.prompt_len, max_new_tokens=t.max_new_tokens,
                slo=t.slo, prompt_seed=hash((seed, ti, k)) & 0x7FFFFFFF))
            k += 1
    reqs.sort(key=lambda r: (r.arrival_time, r.tenant, r.rid))
    if max_requests is not None:
        reqs = reqs[:max_requests]
    return reqs


class ClosedLoopLoad:
    """``concurrency`` virtual clients, one outstanding request each.

    ``initial()`` yields the first wave; each completion is exchanged for
    the tenant's next request via ``next_request`` until ``total`` have
    been issued.  Tenant assignment of clients follows ``weight``.
    """

    def __init__(self, tenants: list[TenantSpec], *, concurrency: int,
                 total: int, seed: int = 0):
        if concurrency < 1:
            raise ValueError(f"concurrency must be >= 1, got {concurrency}")
        self.tenants = {t.name: t for t in tenants}
        self.total = int(total)
        self._issued = 0
        self._rng = random.Random(seed)
        # deterministic largest-remainder split of clients over weights
        wsum = sum(t.weight for t in tenants)
        shares = [(t.name, concurrency * t.weight / wsum) for t in tenants]
        counts = {name: int(s) for name, s in shares}
        rem = sorted(shares, key=lambda p: -(p[1] - int(p[1])))
        for name, _ in rem[:concurrency - sum(counts.values())]:
            counts[name] += 1
        self._clients = [name for name, c in counts.items() for _ in range(c)]

    def _make(self, tenant: str, now: float) -> Request:
        t = self.tenants[tenant]
        k = self._issued
        self._issued += 1
        return Request(
            rid=f"{tenant}-cl{k}", tenant=tenant, arrival_time=now,
            prompt_len=t.prompt_len, max_new_tokens=t.max_new_tokens,
            slo=t.slo, prompt_seed=self._rng.randrange(1 << 31))

    def initial(self) -> list[Request]:
        return [self._make(name, 0.0)
                for name in self._clients if self._issued < self.total]

    def next_request(self, completed: Request, now: float) -> Optional[Request]:
        if self._issued >= self.total:
            return None
        return self._make(completed.tenant, now)
