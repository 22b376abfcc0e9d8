"""The coded-matmul op object: plan -> bind -> apply.

* **plan**   -- ``plan(config, m, n, num_workers)`` designs the code through
  the scheme registry (or ``from_plan(config, p)`` wraps a prebuilt
  ``CodedMatmulPlan``) and returns an unbound ``CodedOp``;
* **bind**   -- ``op.bind(device)`` attaches a torch device: the CUDA card
  by default (raising where there is none), or ``"cpu"``, where the
  kernels' plain PyTorch versions run instead;
* **apply**  -- ``op(A, B)`` runs the coded product on that device.  Backend
  dispatch, BlockELL packing, and the pack cache all live here;
* **rebind** -- ``op.with_survivors(mask)`` re-derives the decode matrix
  from surviving rows eagerly (raising ``DecodingError`` at rebind time)
  and reuses the existing tile pack, which depends only on the task table.

Ops are frozen: every transition returns a new op.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.coded import registry
from repro_torch.coded.config import CodedMatmulConfig
from repro_torch.core import coded_backends
from repro_torch.core.blocks import resolve_device
from repro_torch.core.coded_matmul import (
    CodedMatmulPlan,
    DeviceTilePack,
    WorkerTilePack,
    _host_f32,
    check_operands,
    chunk_mask_progress,
    pack_worker_tiles,
    resolve_pack,
    stage_coded_matmul,
)
from repro_torch.runtime import pack_cache
from repro_torch.sparse.blocksparse import BlockELL, dense_to_block_ell


@dataclasses.dataclass(frozen=True)
class CodedOp:
    """A coded matmul, fully described: design + execution config (+ device).

    Build with ``plan(...)`` / ``from_plan(...)``, not directly.
    ``plan_`` is the survivor-adjusted plan actually run; ``base_plan``
    keeps the original design so tile packs (which depend only on the task
    table) are cached and reused across survivor rebinds.
    """

    config: CodedMatmulConfig
    plan_: CodedMatmulPlan
    base_plan: CodedMatmulPlan
    survivors: np.ndarray | None = None
    device: torch.device | None = None
    chunk_progress: np.ndarray | None = None  # (N,) chunks completed, if partial

    # ------------------------------ lifecycle -------------------------------

    def bind(self, device=None) -> "CodedOp":
        """Attach a torch device: ``None`` means the CUDA card, and raises
        when there is none; pass ``"cpu"`` to run on the CPU."""
        return dataclasses.replace(self, device=resolve_device(device))

    def with_survivors(self, survivors) -> "CodedOp":
        """Rebind to a liveness mask (replaces any previous mask).

        ``survivors`` is an (N,) worker mask, or an (N, q) per-chunk
        completion mask (prefix-form rows: ordered sub-task streams) -- a
        worker that completed only its first chunks contributes exactly
        those slots to the decode.  The decode matrix is re-derived NOW --
        an undecodable mask raises ``DecodingError`` here.  Passing None
        restores the original plan.
        """
        if survivors is None:
            return dataclasses.replace(self, plan_=self.base_plan,
                                       survivors=None, chunk_progress=None)
        mask = np.asarray(survivors, dtype=bool)
        if mask.ndim == 2:
            progress = chunk_mask_progress(mask, self.base_plan.num_workers)
            return dataclasses.replace(
                self,
                plan_=self.base_plan.with_chunk_progress(
                    progress, mask.shape[1]),
                survivors=progress > 0, chunk_progress=progress)
        mask = mask.reshape(-1)
        return dataclasses.replace(
            self, plan_=self.base_plan.with_survivors(mask), survivors=mask,
            chunk_progress=None)

    # ------------------------------- execution ------------------------------

    def pack_for(self, a_sparse: BlockELL, *, use_cache: bool = True) -> WorkerTilePack:
        """The worker tile pack of ``a_sparse`` under this op's design,
        memoized in the pack cache (one pack serves every survivor rebind
        of this op)."""
        if use_cache:
            return pack_cache.get_pack(a_sparse, self.base_plan,
                                       compute_dtype=self.config.compute_dtype)
        return pack_worker_tiles(a_sparse, self.base_plan,
                                 compute_dtype=self.config.compute_dtype)

    def _auto_backend(self, A: torch.Tensor, a_sparse, pack, s: int):
        """Resolve ``backend="auto"``: measure live-tile density, pick.

        Returns ``(backend_name, density, a_sparse)`` -- the BlockELL is
        passed back so a pack built from A is not rebuilt.
        """
        cfg = self.config
        if a_sparse is not None:
            frac = a_sparse.density()
        elif pack is not None:
            # dense-equivalent tile count of the pack: every live slot of
            # every worker could touch all s/bs row-blocks of its stripe
            degrees = np.count_nonzero(self.base_plan.weights, axis=1)
            cbl = pack.vals.shape[1]
            dense_eq = max(1, int(degrees.sum()) * cbl * (s // pack.block_size))
            frac = float(np.asarray(pack.live_tiles).sum()) / dense_eq
        else:
            a_sparse = dense_to_block_ell(_host_f32(A),
                                          block_size=cfg.block_size)
            frac = a_sparse.density()
        chosen = ("block_sparse" if frac <= cfg.auto_density_threshold
                  else "dense_scan")
        return chosen, frac, a_sparse

    def apply(self, A, B, *, a_sparse: BlockELL | None = None,
              pack: WorkerTilePack | None = None) -> torch.Tensor:
        """C = A^T B under this op's code, config, and survivor mask, on
        the bound device (A and B are moved there as f32 if they are not).

        For pack-consuming backends (``block_sparse``), pass ``a_sparse``
        (a host BlockELL of A -- packed once and memoized) or ``pack`` (a
        prebuilt ``WorkerTilePack``); otherwise A is packed with
        ``config.block_size``.  Backends that take no pack reject these
        operands.  ``backend="auto"`` measures the operand's live-tile
        fraction against ``config.auto_density_threshold`` and dispatches
        to block_sparse or dense_scan.
        """
        if self.device is None:
            raise ValueError(
                "unbound CodedOp: call .bind() (or .bind('cpu')) first")
        cfg = self.config
        backend = cfg.backend
        entry = coded_backends.get_backend(backend)
        if not entry.needs_pack and (a_sparse is not None or pack is not None):
            raise ValueError(
                f"backend {backend!r} takes no a_sparse/pack operand")
        A = torch.as_tensor(A, dtype=torch.float32, device=self.device)
        B = torch.as_tensor(B, dtype=torch.float32, device=self.device)
        N, s, r, _, br, _ = check_operands(A, B, self.plan_)
        if entry.virtual:
            backend, _, a_sparse = self._auto_backend(A, a_sparse, pack, s)
            entry = coded_backends.get_backend(backend)
            if not entry.needs_pack:
                a_sparse = pack = None
        dpack = None
        if entry.needs_pack:
            transient = pack is None and a_sparse is None
            if pack is None and a_sparse is not None:
                pack = self.pack_for(a_sparse)
            pack = resolve_pack(
                A, self.base_plan, pack=pack, a_sparse=a_sparse,
                block_size=cfg.block_size, compute_dtype=cfg.compute_dtype,
                num_workers=N, s=s, r=r, br=br)
            # a pack made from A for this call alone is not worth a cache
            # entry (it would pin device memory nobody asks for again)
            dpack = (DeviceTilePack.from_pack(pack, self.device) if transient
                     else pack_cache.device_pack(pack, self.device))
        return stage_coded_matmul(
            A, B, self.plan_,
            alive=self.survivors,
            out_dtype=cfg.torch_dtype,
            backend=backend,
            pack=dpack)

    __call__ = apply

    # ------------------------------ introspection ---------------------------

    @property
    def num_workers(self) -> int:
        return self.plan_.num_workers

    @property
    def needs_pack(self) -> bool:
        """Whether this op's backend consumes host-side pack metadata."""
        return coded_backends.get_backend(self.config.backend).needs_pack

    @property
    def bound(self) -> bool:
        return self.device is not None

    def __repr__(self) -> str:  # the dataclass default dumps whole ndarrays
        surv = (None if self.survivors is None
                else int(self.survivors.sum()))
        chunks = ("" if self.chunk_progress is None
                  else f", chunk_progress={self.chunk_progress.tolist()}")
        return (f"CodedOp(scheme={self.config.scheme!r}, "
                f"backend={self.config.backend!r}, "
                f"m={self.plan_.m}, n={self.plan_.n}, "
                f"workers={self.num_workers}, "
                f"survivors={surv}{chunks}, device={self.device})")


def plan(config: CodedMatmulConfig, m: int, n: int,
         num_workers: int | None = None, *, seed: int = 0,
         max_degree: int | None = None, **scheme_kwargs) -> CodedOp:
    """Design a code for an (m x n)-blocked A^T B over ``num_workers``
    workers and wrap it in an unbound ``CodedOp``."""
    scheme = registry.get_scheme(config.scheme)
    p = scheme.plan(m, n, num_workers, max_degree=max_degree, seed=seed,
                    **scheme_kwargs)
    return CodedOp(config=config, plan_=p, base_plan=p)


def from_plan(config: CodedMatmulConfig, p: CodedMatmulPlan) -> CodedOp:
    """Wrap a prebuilt ``CodedMatmulPlan`` (from ``make_plan``, or
    ``convert.plan_from_numpy``) in an unbound ``CodedOp``."""
    return CodedOp(config=config, plan_=p, base_plan=p)
