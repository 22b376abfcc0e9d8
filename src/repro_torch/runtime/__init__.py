"""The port's runtime: the master/worker straggler runtime and the pack cache.

* straggler models (``SlowWorkers``, ``ExponentialStragglers``, the rate
  models, ...) -- copies of the JAX package's, the same draws from the
  same rng;
* ``run_coded_job`` (seeded event-driven simulation), ``run_live_job``
  (worker threads computing real products), ``JobMux`` / ``MuxJob`` /
  ``MuxResult`` (many jobs over one pool, ``"sim"`` or ``"live"``) and
  ``run_device_job`` (a timed ``CodedOp`` apply), each returning an
  ``ExecutionReport``;
* ``pack_cache`` -- the worker tile packs and their device copies.

Every entry point takes ``device=None``, which means the CUDA card and
raises where there is none; ``device="cpu"`` runs on the CPU.  Numpy and
scipy blocks are moved to the device once, when a job starts, and the
report's blocks are torch tensors there.

Exports resolve lazily (PEP 562), so importing the package loads nothing.
"""

_EXPORTS = {
    "repro_torch.runtime.straggler": (
        "StragglerModel", "RateModel", "NoStragglers", "SlowWorkers",
        "SlowWorkerRates", "LogNormalRates", "ExponentialStragglers",
        "ShiftedExponential"),
    "repro_torch.runtime.executor": (
        "ExecutionReport", "JobMux", "MuxJob", "MuxResult", "run_coded_job",
        "run_device_job", "run_live_job"),
}

_HOMES = {name: module for module, names in _EXPORTS.items() for name in names}
__all__ = [*_HOMES, "pack_cache"]


def __getattr__(name):
    import importlib

    if name == "pack_cache":
        return importlib.import_module("repro_torch.runtime.pack_cache")
    if name in _HOMES:
        return getattr(importlib.import_module(_HOMES[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
