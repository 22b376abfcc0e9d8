"""repro_torch.serving: multi-tenant coded serving on PyTorch.

The scheduler and the load generator are torch-free host logic and import
eagerly; the engine and the serving steps pull in the model (and torch),
so they load lazily -- importing ``repro_torch.serving`` for scheduling
and metrics loads neither.  ``cached_decode_step`` stands where the JAX
package exports ``jitted_decode_step``.
"""

from repro_torch.serving.loadgen import ClosedLoopLoad, TenantSpec, poisson_trace
from repro_torch.serving.scheduler import (SLO, ContinuousBatcher, Request,
                                           ServingMetrics, percentile)

__all__ = [
    "SLO", "Request", "ContinuousBatcher", "ServingMetrics", "percentile",
    "TenantSpec", "poisson_trace", "ClosedLoopLoad",
    "ServingEngine", "generate", "cached_decode_step",
]

_LAZY = {
    "ServingEngine": ("repro_torch.serving.engine", "ServingEngine"),
    "generate": ("repro_torch.serving.serve_step", "generate"),
    "cached_decode_step": ("repro_torch.serving.serve_step", "cached_decode_step"),
}


def __getattr__(name):
    try:
        mod, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), attr)
