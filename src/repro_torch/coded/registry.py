"""Scheme registry: every coded-computation scheme, selectable by name.

A *scheme* is a code design in the block domain (paper section II): a rule
for building the generator matrix M over the mn unknown block products.
``Scheme.plan(...)`` turns the instance's own generator matrix into the
port's device plan (``repro_torch.core.coded_matmul.CodedMatmulPlan``), so
the plan of a name, m, n, N and seed is the same as the JAX package's,
field for field.

Registering a new scheme::

    @register_scheme("my_code")
    def my_code(m, n, N, seed=0):      # -> CodeInstance
        ...
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core import schemes as schemes_lib
from repro_torch.core.schemes import CodeInstance, SchemeInvariants


@dataclasses.dataclass(frozen=True)
class CodeDesign:
    """Static identity of a registry-built device plan (the stand-in for
    ``SparseCodeSpec`` in ``CodedMatmulPlan.spec``: exposes the m/n/
    num_workers the plan properties read, plus provenance)."""

    m: int
    n: int
    num_workers: int
    scheme: str
    seed: int

    @property
    def mn(self) -> int:
        return self.m * self.n


@dataclasses.dataclass(frozen=True)
class Scheme:
    """One registered code design; builds host instances and device plans."""

    name: str
    builder: Callable[..., CodeInstance]   # (m, n, N, *, seed=..., **kw)
    fixed_workers: bool = False            # uncoded: N is forced to m*n
    truncates: bool = False                # degree-distribution designs get
    #   the lockstep default truncation (~2 ln(mn)) in plan(); dense designs
    #   keep every entry of their rows
    invariants: SchemeInvariants | None = None

    def instance(self, m: int, n: int, num_workers: int | None = None,
                 *, seed: int = 0, **kwargs) -> CodeInstance:
        """The generator-matrix realization (``CodeInstance``) of this design."""
        if self.fixed_workers:
            if num_workers not in (None, m * n):
                raise ValueError(
                    f"scheme {self.name!r} uses exactly m*n={m * n} workers, "
                    f"got num_workers={num_workers}")
            return self.builder(m, n)
        if num_workers is None:
            raise ValueError(f"scheme {self.name!r} needs num_workers")
        return self.builder(m, n, num_workers, seed=seed, **kwargs)

    def chunked(self, m: int, n: int, num_workers: int | None = None, *,
                num_chunks: int, seed: int = 0, **kwargs):
        """Chunk-granular host realization: ``instance(...).chunked(q)``.

        Every registered scheme supports this -- chunking operates on the
        sampled generator matrix, so it passes through the registry with no
        per-scheme code.
        """
        return self.instance(m, n, num_workers, seed=seed,
                             **kwargs).chunked(num_chunks)

    def device_capable(self, m: int = 2, n: int = 2,
                       num_workers: int | None = None, **kwargs) -> bool:
        """Whether this design maps onto the device path (one generator row
        per worker)."""
        inst = self.instance(m, n, num_workers or 4 * m * n, **kwargs)
        return all(len(rows) == 1 for rows in inst.worker_rows)

    def plan(self, m: int, n: int, num_workers: int | None = None, *,
             max_degree: int | None = None, seed: int = 0,
             max_resample: int = 50, **kwargs):
        """The device-path plan (``CodedMatmulPlan``) of the same design.

        Rows are truncated to ``max_degree`` task slots (None = the
        instance's own max row degree, i.e. no truncation, except for the
        degree-distribution designs, which get the lockstep default), the
        truncated system is rank-checked, and the linear decode matrix is
        its pseudo-inverse.  Resamples ``seed + i`` until full rank.
        """
        from repro_torch.core.coded_matmul import CodedMatmulPlan
        from repro_torch.core.decoder import decode_matrix

        d = m * n
        if max_degree is None and self.truncates:
            # every worker pays for the max degree, so cap it at ~2 ln(mn)
            # (decodability re-checked below)
            max_degree = max(
                1, min(d, int(np.ceil(2 * np.log(max(d, 2)) + 1))))
        for attempt in range(max_resample):
            inst = self.instance(m, n, num_workers, seed=seed + attempt,
                                 **kwargs)
            if any(len(rows) != 1 for rows in inst.worker_rows):
                raise ValueError(
                    f"scheme {self.name!r} assigns multiple generator rows "
                    "per worker; it has no one-row-per-worker device plan")
            N = inst.num_workers
            M = inst.M.tocsr()
            degrees = np.diff(M.indptr)
            L = int(max_degree or max(1, degrees.max(initial=1)))
            cols = np.zeros((N, L), dtype=np.int32)
            weights = np.zeros((N, L), dtype=np.float32)
            Mt = np.zeros((N, d))
            for k in range(N):
                lo, hi = M.indptr[k], M.indptr[k + 1]
                take = min(hi - lo, L)
                cols[k, :take] = M.indices[lo:lo + take]
                weights[k, :take] = M.data[lo:lo + take]
                Mt[k, M.indices[lo:lo + take]] = M.data[lo:lo + take]
            if np.linalg.matrix_rank(Mt) >= d:
                design = CodeDesign(m=m, n=n, num_workers=N,
                                    scheme=self.name, seed=seed + attempt)
                return CodedMatmulPlan(
                    spec=design, cols=cols, weights=weights,
                    decode=decode_matrix(Mt).astype(np.float32),
                    max_degree=L)
            if self.fixed_workers:
                break  # deterministic design: resampling cannot help
        raise RuntimeError(
            f"scheme {self.name!r}: no full-rank truncated coefficient "
            f"matrix after {max_resample} tries (max_degree={max_degree})")


_REGISTRY: dict[str, Scheme] = {}


def register_scheme(name: str, builder: Callable | None = None, *,
                    fixed_workers: bool = False, truncates: bool = False,
                    invariants: SchemeInvariants | None = None):
    """Register a scheme builder under ``name`` (usable as a decorator).

    ``invariants`` is the design's static decodability profile; built-ins
    declare theirs in ``repro_torch.core.schemes.INVARIANTS``.
    """

    def _register(fn):
        _REGISTRY[name] = Scheme(
            name=name, builder=fn, fixed_workers=fixed_workers,
            truncates=truncates,
            invariants=invariants or schemes_lib.INVARIANTS.get(name))
        return fn

    if builder is None:
        return _register
    _register(builder)
    return _REGISTRY[name]


def get_scheme(name: str) -> Scheme:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"scheme {name!r} not in {scheme_names()}") from None


def scheme_names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


# ---------------------- built-in scheme registrations -----------------------
# Builders normalize to (m, n, N, *, seed, **kw); the underlying ctors live
# in repro_torch.core.schemes and keep their positional signatures.

register_scheme("uncoded", lambda m, n: schemes_lib.uncoded(m, n),
                fixed_workers=True)
register_scheme("sparse_code",
                lambda m, n, N, *, seed=0, **kw:
                schemes_lib.sparse_code(m, n, N, seed=seed, **kw),
                truncates=True)
register_scheme("lt_code",
                lambda m, n, N, *, seed=0:
                schemes_lib.lt_code(m, n, N, seed=seed),
                truncates=True)
register_scheme("sparse_mds",
                lambda m, n, N, *, seed=0, **kw:
                schemes_lib.sparse_mds_code(m, n, N, seed=seed, **kw))
register_scheme("polynomial",
                lambda m, n, N, *, seed=0:
                schemes_lib.polynomial_code(m, n, N, seed=seed))
register_scheme("mds",
                lambda m, n, N, *, seed=0:
                schemes_lib.mds_code(m, n, N, seed=seed))
register_scheme("product",
                lambda m, n, N, *, seed=0:
                schemes_lib.product_code(m, n, N, seed=seed))
