"""The port's runtime: the master/worker straggler runtime and the pack cache.

* straggler models (``SlowWorkers``, ``ExponentialStragglers``, the rate
  models, ...) -- copies of the JAX package's, the same draws from the
  same rng;
* ``run_coded_job`` (seeded event-driven simulation), ``run_live_job``
  (worker threads computing real products), ``JobMux`` / ``MuxJob`` /
  ``MuxResult`` (many jobs over one pool, ``"sim"``, ``"live"`` or a
  ``MuxProcPool``), ``run_device_job`` (a timed ``CodedOp`` apply) and
  ``run_group_job`` (the same with one worker a process, over a
  ``torch.distributed`` group; ``run_group_jobs`` several configurations
  in one launch), each returning an ``ExecutionReport``;
* the process runtime: ``run_proc_job`` / ``ProcPool`` (one job over
  worker processes that can be killed, frozen or slowed; a
  ``WorkerProcesses`` keeps them for the next job) and ``MuxProcPool``, with the fault plans of ``runtime.chaos``
  (``FaultPlan``, ``FaultLedger``, and ``FaultRealization``, the same plan
  on the simulator's timeline);
* ``workergroup`` -- the worker axis as a process group: ``spawn_group``,
  ``init_worker_group`` and the operands in shared memory;
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
        "run_device_job", "run_group_job", "run_group_jobs", "run_live_job"),
    "repro_torch.runtime.chaos": ("FaultLedger", "FaultPlan", "FaultRealization"),
    "repro_torch.runtime.procpool": ("MuxProcPool", "ProcPool", "WorkerProcesses",
                                     "run_proc_job"),
    "repro_torch.runtime.workergroup": ("SharedArrays", "init_worker_group", "spawn_group"),
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
