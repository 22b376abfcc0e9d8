"""The harness: a cell found by name, one run of it, and its result line.

A cell ``<config>.<mix>`` of ``BENCHMARK.json`` names a configuration file
(``configs/<config>.json``: the sizes, the fixed code, the limits of the
check, the source), a traffic mix (``traffic/<mix>.json``, read by
``loadgen``) and the per-layer metrics that list it, each a reader of its
own (``metrics/<metric>.py``).  Nothing here knows a cell by name.

A run, on one card:

1. set-up: draw the operands from the seed (``operands``), plan the
   configuration's code and check it is the file's, bind, and warm up with
   one apply for each failure pattern of the mix;
2. the window: a closed loop of applies for ``seconds``; an apply runs from
   its call, the rebind to its failure pattern included, to its C on the
   device (a synchronise); traced, under ``torch.profiler``;
3. the check: rows drawn from the seed of an apply of the window drawn
   from the seed, the whole answer of its last apply, and of one apply for
   each of a few more patterns the window used, drawn from the seed,
   against the plain reference (``reference``), once the peak memory has
   been read and the program's state freed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

from portbench import faults, loadgen, operands, reference, tracing, yardstick

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH_FILE = ROOT / "BENCHMARK.json"
METRICS_DIR = HERE / "metrics"
#: top-level modules the process that prints a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the sampled answer of the window is drawn from its first this many
#: applies, and of it this many rows (1 MiB at the widest cell: a block of
#: the allocator's small pool, so that the window's large blocks keep the
#: layout the warm-up gave them; a whole answer held there moved them, and
#: a few applies after it paid seconds to the allocator)
SAMPLED_FROM = 32
SAMPLED_ROWS = 16
#: patterns the window used that are checked besides those of its two
#: answers, drawn from the seed
MORE_CHECKED = 2
NVIDIA_SMI_FIELDS = ("index", "clocks.sm", "clocks.mem", "power.draw", "power.limit",
                     "temperature.gpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    #: BENCHMARK.json's end_to_end, and the per_layer entries that list this cell
    end_to_end: list
    per_layer: list


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json, with its files read."""
    bench = bench if bench is not None else json.loads(BENCH_FILE.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                mix=loadgen.load_mix(w["traffic"]), end_to_end=list(bench["end_to_end"]),
                per_layer=per_layer)


def load_reader(metric: str):
    """The reader module of a per-layer metric (``metrics/<metric>.py``)."""
    path = METRICS_DIR / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r}: {path} is missing")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(names=None) -> list[str]:
    """The FORBIDDEN top-level names among ``names`` (this process's
    modules by default), compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def boot_clock() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """When this process started, on ``boot_clock`` (to 1 / CLK_TCK s)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


# ------------------------------------------------------------------ the card


class PowerSampler:
    """``nvidia-smi`` sampled once a second beside the window, in a process
    of its own that ``stop`` ends and waits for; absent on a machine
    without it."""

    def __init__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={','.join(NVIDIA_SMI_FIELDS)}",
                 "--format=csv,noheader,nounits", "-lms", "1000"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except FileNotFoundError:
            self.proc = None

    def stop(self) -> dict:
        if self.proc is None:
            return {"nvidia_smi": "not available"}
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        by = {}
        for line in out.splitlines():
            vals = [v.strip() for v in line.split(",")]
            if len(vals) != len(NVIDIA_SMI_FIELDS):
                continue
            row = by.setdefault(vals[0], {k: [] for k in NVIDIA_SMI_FIELDS[1:]})
            for key, v in zip(NVIDIA_SMI_FIELDS[1:], vals[1:]):
                with contextlib.suppress(ValueError):
                    row[key].append(float(v))
        return {f"gpu{idx}": {k: [min(v), max(v)] if v else None for k, v in row.items()}
                | {"samples": len(row["clocks.sm"])} for idx, row in by.items()}


# ------------------------------------------------------------------ one run


def _synchronize(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def session(config: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
            fault: str | None = None) -> dict:
    """One run's set-up, window and check on ``device``; plain data out."""
    with faults.planted(fault):
        return _session(config, mix, seed, seconds, trace, device)


def _session(config, mix, seed, seconds, trace, device) -> dict:
    import torch

    from repro_torch.coded import CodedMatmulConfig, plan
    from repro_torch.runtime import pack_cache

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.empty(0, device=dev)  # the allocator exists before its peak is reset
        torch.cuda.reset_peak_memory_stats(dev)
    s, r, t, bs = operands.geometry(config)
    N = config["num_workers"]
    M = np.asarray(config["coefficients"], dtype=np.float64)

    stages = {"started": boot_clock()}
    ops = operands.draw(config, seed, dev)
    ell = operands.block_ell(ops, config)
    _synchronize(dev)
    if cuda:
        torch.cuda.empty_cache()  # the draw's temporaries go before the program runs
    stages["drawn"] = boot_clock()
    cfg = CodedMatmulConfig(scheme=config["scheme"], backend=config["backend"], block_size=bs)
    op = plan(cfg, config["m"], config["n"], N, seed=config["code_seed"]).bind(dev)
    if not np.array_equal(op.base_plan.coefficient_matrix(), M):
        raise RuntimeError(
            f"the program's {config['scheme']} plan for code_seed {config['code_seed']} is "
            f"not the configuration's code:\n{op.base_plan.coefficient_matrix()}\nvs\n{M}")
    cyc = loadgen.cycle(mix, M, seed)
    masks = [loadgen.survivors(dead, N) for dead in cyc]

    def rebound(mask):
        return op if mask is None else op.with_survivors(mask)

    stages["planned"] = boot_clock()
    for mask in masks:  # warm-up: every pattern the window will apply, once
        C = rebound(mask).apply(ops.A, ops.B, a_sparse=ell)
        _synchronize(dev)
        stages.setdefault("first_apply", boot_clock())
    del C
    stages["warm"] = boot_clock()

    rng = np.random.default_rng([int(seed), 2])
    sampled_at = int(rng.integers(SAMPLED_FROM))
    rows = torch.as_tensor(np.sort(rng.choice(r, SAMPLED_ROWS, replace=False)), device=dev)
    answers = []                               # (pattern index, C or its sampled rows, rows)
    lat, rebind_s = [], 0.0
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []))
        prof.__enter__()
        span = record_function
    else:
        def span(_name):
            return contextlib.nullcontext()
    sampler = PowerSampler() if cuda else None
    try:
        _synchronize(dev)
        window_start = boot_clock()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        with span(tracing.WINDOW_SPAN):
            while True:
                p = i % len(masks)
                a = time.perf_counter()
                if masks[p] is None:
                    this = op
                else:
                    with span("rebind"):
                        this = op.with_survivors(masks[p])
                    rebind_s += time.perf_counter() - a
                with span("apply"):
                    C = this.apply(ops.A, ops.B, a_sparse=ell)
                _synchronize(dev)
                b = time.perf_counter()
                lat.append(b - a)
                if i == sampled_at:
                    answers.append((p, C[rows], rows))
                i += 1
                if b >= deadline:
                    break
        window_s = time.perf_counter() - t0
        applies = i
        answers.append(((applies - 1) % len(masks), C, None))
    finally:  # the sampler ends with the window, whatever happened in it
        power = sampler.stop() if sampler is not None else None
    del C
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    trace_out = None
    if prof is not None:
        prof.__exit__(None, None, None)
        trace_out = tracing.reduce(tracing.export(prof))
        del prof

    # ---- the check: the window's answers and a few more patterns it used
    used = sorted({k % len(masks) for k in range(applies)})
    rest = [p for p in used if p not in {p for p, _, _ in answers}]
    for p in rng.permutation(rest)[:MORE_CHECKED]:
        answers.append((int(p), rebound(masks[p]).apply(ops.A, ops.B, a_sparse=ell), None))
    checked = sorted({p for p, _, _ in answers})
    del this, op, ell
    pack_cache.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rel = {}  # the widest gap, apart for answers with every worker alive
    ref = reference.product(ops.A, ops.B)
    scale = float(ref.abs().max())
    for p, C, at in answers:
        name = "rel_err_dead" if cyc[p] else "rel_err_alive"
        gap = reference.rel_err(C, ref if at is None else ref[at], scale)
        rel[name] = max(rel.get(name, 0.0), gap)
    del ref, answers

    live = yardstick.live_mask(ops.rows.cpu().numpy(), ops.nnzb.cpu().numpy(), s, bs)
    work = yardstick.launch_work(M, (s, r, t, bs, config["m"], config["n"]), live)
    return {
        "applies": applies, "window_s": window_s, "window_start": window_start,
        "latencies_s": lat,
        "rebind_s": rebind_s if any(m is not None for m in masks) else None,
        "pattern_of_apply": [cyc[k % len(masks)] for k in range(applies)],
        "patterns": [list(d) for d in cyc], "patterns_checked": [list(cyc[p]) for p in checked],
        "peak_bytes": peak, "power": power, "trace": trace_out,
        "rel_err": rel, "work": work,
        "degrees": [int(np.count_nonzero(row)) for row in M],
        "live_tiles": ops.live_tiles,
        "device_name": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "forbidden": forbidden_modules(), "stages": stages,
    }


def run(cell: Cell, seed: int, seconds: float, trace: bool, *, device=None,
        fault: str | None = None, start: float | None = None) -> tuple[dict, dict, list]:
    """One run of ``cell``: (its result line, the line of what fixed its
    work, the check lines).  ``device`` None is the card; ``"cpu"`` runs
    the port's CPU lane."""
    import torch

    start = process_start() if start is None else start
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    lead = session(cell.config, cell.mix, seed, seconds, trace, dev, fault=fault)
    return assemble(cell, lead, trace, start, seed)


def assemble(cell: Cell, lead: dict, trace: bool, start: float, seed: int):
    applies = lead["applies"]
    limits = cell.config["limits"]
    compared = dict(lead["rel_err"])
    missing = sorted(set(compared) - set(limits))
    if missing:
        raise KeyError(f"{cell.config['name']} states no limit for {missing}")
    checks = {name: {"value": compared[name], "limit": limits[name]} for name in compared}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    peaks = yardstick.PEAKS.get(lead["device_name"])
    lat = lead["latencies_s"]
    if not trace:
        values = {
            "apply_ms": lead["window_s"] * 1e3 / applies,
            "apply_p95_ms": (statistics.quantiles(lat, n=20, method="inclusive")[-1] * 1e3
                             if len(lat) > 1 else lat[0] * 1e3),
            "peak_device_gib": lead["peak_bytes"] / 2**30,
            "setup_s": lead["window_start"] - start,
        }
    else:
        readings = Readings(
            applies=applies, window_s=lead["window_s"], trace=lead["trace"],
            spmm_bound_s=(None if peaks is None else sum(
                yardstick.apply_bound_s(lead["work"], tuple(d), peaks)
                for d in lead["pattern_of_apply"])),
            rebind_s=lead["rebind_s"])
        values = {}
        for m in cell.per_layer:
            reader = load_reader(m["name"])
            if reader.UNIT != m["unit"]:
                raise ValueError(f"metric {m['name']}: reader's unit {reader.UNIT!r} != "
                                 f"BENCHMARK.json's {m['unit']!r}")
            v = reader.read(readings)
            if v is not None:
                values[m["name"]] = v
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    values = {k: v for k, v in values.items() if k in units}
    device = {"platform": "gpu" if lead["device_name"] != "cpu" else "cpu",
              "kind": lead["device_name"], "count": 1, "memory_peak_bytes": lead["peak_bytes"]}
    result = {"correct": correct, "attempted": applies, "failed": 0,
              "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
              "device": device}
    if trace and lead["trace"] is not None:
        device["busy_s"] = lead["trace"].busy_s
        device["window_s"] = lead["trace"].window_s
        result["breakdown"] = {"device_ops": lead["trace"].top_ops(),
                               "idle_gaps": lead["trace"].idle_gaps}
    result["checks"] = checks
    work = {
        "workload": cell.name, "seed": seed, "code": {
            k: cell.config[k] for k in ("scheme", "m", "n", "num_workers", "code_seed")},
        "degrees": lead["degrees"], "sum_degree": sum(lead["degrees"]),
        "live_tiles": lead["live_tiles"],
        "live_slots": sum(w["slots"] for w in lead["work"]),
        "patterns": lead["patterns"], "patterns_checked": lead["patterns_checked"],
        "applies": applies, "window_s": lead["window_s"], "power": lead["power"],
        "setup_stages_s": _stage_lengths(start, lead["stages"], lead["window_start"]),
        "forbidden_modules": lead["forbidden"],
    }
    lines = [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
             for name, c in checks.items()]
    return result, work, lines


def _stage_lengths(start: float, stages: dict, window_start: float) -> dict:
    """Seconds of each part of set-up: to the session's start (imports, the
    card), the draw, the plan, the first apply (the pack, a first run's
    build), the rest of the warm-up, and to the window."""
    marks = [("process", start), *stages.items(), ("window", window_start)]
    return {name: b - a for (_, a), (name, b) in zip(marks, marks[1:])}


@dataclasses.dataclass
class Readings:
    """What a per-layer metric's reader reads (``metrics/*.py``)."""

    applies: int
    window_s: float
    #: the device trace of the window (None untraced or without one)
    trace: tracing.DeviceTrace | None
    #: the least time of every fused-decode launch of the window, summed
    #: (None where the card's peaks are not in the yardstick's table)
    spmm_bound_s: float | None
    #: host seconds of the window's rebinds (None where the mix has none)
    rebind_s: float | None
