"""Registry of local-compute backends for the coded matmul device path.

The port's OWN table: the JAX package attaches its staging functions to
the entries of its table, so sharing one would swap the reference out
whenever both packages run in one process.

A backend is the strategy one worker uses to evaluate its coded
combination ``sum_l w_kl A_{i_l}^T B_{j_l}`` on the device.  The entry here
carries the *metadata* the API layer needs for dispatch and validation;
the staging function itself lives in ``repro_torch.core.coded_matmul`` and
attaches when that module loads.  Registering a new backend makes it a
legal value for ``CodedMatmulConfig.backend`` and routes ``CodedOp``
dispatch once a ``local_product_factory`` is attached.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass
class Backend:
    """One registered local-compute strategy.

    needs_pack: whether the backend consumes host-side pack metadata (a
    ``WorkerTilePack``).
    local_product_factory: attached by the implementing module; called as
    ``factory(plan, pack) -> (k, A, B) -> (br, bt)`` at staging time.
    fused_decode: the backend folds the decode combine into its local
    product's epilogue -- staging then calls ``fused_local_product_factory``
    (``factory(plan, pack) -> (k, A, B, dvec) -> (mn, br, bt)``) and no
    separate ``D @ C~`` contraction runs.
    virtual: a dispatch pseudo-backend (``"auto"``) that the API layer
    resolves to a concrete backend before staging; staging rejects it.
    """

    name: str
    needs_pack: bool = False
    doc: str = ""
    local_product_factory: Optional[Callable] = None
    fused_decode: bool = False
    fused_local_product_factory: Optional[Callable] = None
    virtual: bool = False


#: tile dtypes the pack layer can quantize coded compute to, with their
#: worst-case RELATIVE per-element rounding error.  The config layer
#: multiplies this by the scheme's declared decode conditioning
#: (``cond_warn``) to accept or reject the pairing.
QUANT_EPS = {
    "float32": 0.0,
    "bfloat16": 2.0 ** -8,   # 8 mantissa bits
    "int8": 1.0 / 127.0,     # symmetric per-tile amax/127 grid
}

#: eps * cond_warn above this and decode may amplify tile rounding error
#: past usable precision -- the config constructor rejects the pairing
QUANT_COND_BUDGET = 1.0e6


_REGISTRY: dict[str, Backend] = {}


def register_backend(name: str, *, needs_pack: bool = False, doc: str = "",
                     fused_decode: bool = False,
                     virtual: bool = False) -> Backend:
    """Register (or return the existing entry for) a backend name."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    entry = Backend(name=name, needs_pack=needs_pack, doc=doc,
                    fused_decode=fused_decode, virtual=virtual)
    _REGISTRY[name] = entry
    return entry


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"backend {name!r} not in {backend_names()}") from None


def backend_names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


register_backend(
    "dense_scan",
    doc="a loop of dense block products (torch.matmul) over the padded "
        "task slots",
)
register_backend(
    "block_sparse", needs_pack=True, fused_decode=True,
    doc="fused-gather block-sparse SpMM (a CUDA kernel) over per-worker "
        "packed tiles of A; the decode combine rides in the kernel "
        "epilogue -- one launch per worker, no D @ C~",
)
register_backend(
    "auto", needs_pack=True, virtual=True,
    doc="density-keyed dispatch: measures the operand's BlockELL live-tile "
        "fraction and picks block_sparse below the configured threshold, "
        "dense_scan above it (resolved by CodedOp before staging)",
)
