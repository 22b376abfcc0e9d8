"""Frozen configuration for one coded-matmul deployment.

Every execution knob is validated ONCE at construction against the port's
registries (``repro_torch.coded.registry`` for schemes,
``repro_torch.core.coded_backends`` for backends), with the JAX package's
rules and defaults.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import coded_backends
from repro_torch.coded import registry


def _canonical_dtype(dtype) -> str:
    """The canonical name of any dtype spelling: a ``torch.dtype``, a numpy
    dtype or its name.  numpy has no bfloat16, so that name passes as is."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str) and dtype == "bfloat16":
        return dtype
    return np.dtype(dtype).name


@dataclasses.dataclass(frozen=True)
class CodedMatmulConfig:
    """How a coded matmul executes (not WHAT it computes -- that is the plan).

    scheme      -- code design name in the scheme registry
    backend     -- local-compute strategy name in the backend registry;
                   ``"auto"`` defers the block_sparse/dense_scan choice to
                   the measured live-tile density of the packed operand
                   (below ``auto_density_threshold`` -> block_sparse)
    block_size  -- tile edge for auto-packing A on pack-consuming backends
    out_sharded -- decode layout: False = replicated sum over workers,
                   True = each worker reduces only its block shard
    out_dtype   -- result dtype (any torch/numpy spelling; normalized)
    axis_name   -- the name of the worker axis
    compute_dtype -- tile dtype of the packed coded compute: "float32"
                   (exact), "bfloat16", or "int8" (per-tile scales, folded
                   into the coding weights at staging time).  Quantized
                   dtypes are budgeted against the scheme's ``cond_warn``
                   decode-conditioning declaration at construction.
    auto_density_threshold -- live-tile fraction above which ``"auto"``
                   picks dense_scan
    """

    scheme: str = "sparse_code"
    backend: str = "dense_scan"
    block_size: int = 8
    out_sharded: bool = False
    out_dtype: str = "float32"
    axis_name: str = "model"
    compute_dtype: str = "float32"
    auto_density_threshold: float = 0.25

    def __post_init__(self):
        registry.get_scheme(self.scheme)           # raises with known names
        coded_backends.get_backend(self.backend)   # raises with known names
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if not self.axis_name:
            raise ValueError("axis_name must be a non-empty axis name")
        if not 0.0 <= self.auto_density_threshold <= 1.0:
            raise ValueError(
                "auto_density_threshold is a live-tile fraction in [0, 1], "
                f"got {self.auto_density_threshold}")
        if self.compute_dtype not in coded_backends.QUANT_EPS:
            raise ValueError(
                f"compute_dtype {self.compute_dtype!r} not in "
                f"{sorted(coded_backends.QUANT_EPS)}")
        if self.compute_dtype != "float32":
            if not coded_backends.get_backend(self.backend).needs_pack:
                raise ValueError(
                    f"compute_dtype {self.compute_dtype!r} quantizes the "
                    f"PACKED tiles; backend {self.backend!r} takes no pack "
                    "-- use block_sparse (or auto)")
            eps = coded_backends.QUANT_EPS[self.compute_dtype]
            cond = registry.get_scheme(self.scheme).invariants.cond_warn
            if eps * cond > coded_backends.QUANT_COND_BUDGET:
                raise ValueError(
                    f"scheme {self.scheme!r} declares decode conditioning "
                    f"up to {cond:.0e}; {self.compute_dtype} tile rounding "
                    f"(eps={eps:.1e}) could amplify to {eps * cond:.1e} "
                    f"> budget {coded_backends.QUANT_COND_BUDGET:.0e} -- "
                    "use float32 for this scheme")
        canonical = _canonical_dtype(self.out_dtype)
        # the device path accumulates in f32 by design: reject every
        # spelling of a 64-bit float/complex result
        if canonical in ("float64", "complex128"):
            raise ValueError(
                f"out_dtype {self.out_dtype!r} normalizes to {canonical}: "
                "the device path is f32-accumulated by design; use "
                "float32/bfloat16/float16")
        if not isinstance(getattr(torch, canonical, None), torch.dtype):
            raise ValueError(f"out_dtype {self.out_dtype!r} has no torch dtype")
        object.__setattr__(self, "out_dtype", canonical)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.out_dtype)
