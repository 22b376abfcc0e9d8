"""Declarative fault plans for the out-of-process runtime (DESIGN.md sec 10).

The thread runtime can only *simulate* stragglers (injected sleeps inside one
GIL-sharing process); the process runtime (``runtime.procpool``) promotes
workers to real OS subprocesses, and this module injects real faults into
them:

* ``kill(w, after_chunk=c)``    -- SIGKILL worker w when its chunk c arrives
                                   at the master (so it dies mid-chunk c+1);
                                   ``after_chunk=None`` kills at spawn.
* ``pause(w, after_chunk=c)``   -- SIGSTOP on the same trigger; with
                                   ``duration=d`` a timer sends SIGCONT d
                                   seconds later, otherwise the worker stays
                                   frozen until pool shutdown.  A pause
                                   longer than the master's heartbeat
                                   deadline is indistinguishable from a hang
                                   -- which is the point.
* ``slow(w, factor=f)``         -- throttle worker w to ~1/f of real time by
                                   duty-cycling SIGSTOP/SIGCONT (run 1 slice,
                                   freeze f-1 slices).  A genuine slowdown:
                                   the OS deschedules the process, no
                                   cooperation from worker code.
* ``drop_result(w, chunk=c)``   -- the master discards worker w's chunk-c
                                   message on arrival (a lost message).  Sub-
                                   task streams are ordered, so the drop
                                   severs w's stream: later chunks of w are
                                   not consumable and w stops being expected.

A ``FaultPlan`` is just a tuple of these; ``FaultInjector`` executes it
against live worker pids from the master side, recording every action in a
``FaultLedger`` that the pool extends with what the master *observed* (crash
exit codes, missed heartbeat deadlines, respawns) and ``run_proc_job``
finalizes with the per-worker equation loss/recovery accounting.

``FaultRealization`` maps the same plan onto the event-driven simulator's
chunk timeline, so ``run_coded_job`` predicts the recovery time of the exact
fault realization ``run_proc_job`` executes for real.

A copy of the JAX package's module (host code, no tensor in it):
``FaultRealization`` gives the reference's chunk timeline bit for bit.

Signals are POSIX-only; constructing a plan that needs them raises on other
platforms rather than degrading silently.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time

import numpy as np

from repro_torch.runtime.straggler import StragglerModel

FAULT_KINDS = ("kill", "pause", "slow", "drop_result")

#: run-slice length of the slow() duty cycle, seconds.  One slice runs, then
#: (factor - 1) slices are spent SIGSTOPped, so the long-run service rate is
#: 1/factor of nominal.
SLOW_SLICE = 0.05


def _require_posix_signals() -> None:
    if not hasattr(signal, "SIGSTOP"):  # pragma: no cover - non-POSIX only
        raise RuntimeError(
            "chaos faults drive SIGSTOP/SIGCONT/SIGKILL and need a POSIX "
            "platform")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned fault.  Use the ``kill``/``pause``/``slow``/
    ``drop_result`` constructors instead of instantiating directly."""

    kind: str
    worker: int
    after_chunk: int | None = None   # trigger on this chunk's arrival (kill/pause)
    duration: float | None = None    # pause: seconds until SIGCONT (None = never)
    factor: float = 1.0              # slow: throttle factor
    chunk: int | None = None         # drop_result: which chunk message is lost

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.worker < 0:
            raise ValueError(f"worker must be >= 0, got {self.worker}")
        if self.kind == "slow" and self.factor <= 1.0:
            raise ValueError(f"slow factor must be > 1, got {self.factor}")
        if self.kind == "drop_result" and self.chunk is None:
            raise ValueError("drop_result needs the chunk to drop")


def kill(worker: int, after_chunk: int | None = None) -> Fault:
    """SIGKILL ``worker`` when its chunk ``after_chunk`` arrives (None: at
    spawn).  The death is real -- exit code -SIGKILL, pipe EOF mid-stream."""
    _require_posix_signals()
    return Fault(kind="kill", worker=worker, after_chunk=after_chunk)


def pause(worker: int, after_chunk: int | None = None,
          duration: float | None = None) -> Fault:
    """SIGSTOP ``worker`` on the trigger; SIGCONT after ``duration`` seconds
    (None: frozen until shutdown).  Freezes heartbeats too, so a pause past
    the master's deadline is detected exactly like a hang."""
    _require_posix_signals()
    return Fault(kind="pause", worker=worker, after_chunk=after_chunk,
                 duration=duration)


def slow(worker: int, factor: float = 10.0) -> Fault:
    """Throttle ``worker`` to ~1/factor speed by SIGSTOP/SIGCONT duty
    cycling from spawn onward."""
    _require_posix_signals()
    return Fault(kind="slow", worker=worker, factor=float(factor))


def drop_result(worker: int, chunk: int) -> Fault:
    """Lose ``worker``'s ``chunk`` message at the master.  Ordered sub-task
    streams mean the drop severs the rest of the worker's stream."""
    return Fault(kind="drop_result", worker=worker, chunk=int(chunk))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A declarative set of faults, validated against the job's geometry."""

    faults: tuple[Fault, ...] = ()

    @classmethod
    def coerce(cls, plan) -> "FaultPlan":
        if plan is None:
            return cls()
        if isinstance(plan, FaultPlan):
            return plan
        if isinstance(plan, Fault):
            return cls(faults=(plan,))
        return cls(faults=tuple(plan))

    @property
    def workers(self) -> list[int]:
        return sorted({f.worker for f in self.faults})

    def validate(self, num_workers: int, num_chunks: int) -> None:
        for f in self.faults:
            if f.worker >= num_workers:
                raise ValueError(
                    f"fault {f.kind} targets worker {f.worker}, job has "
                    f"{num_workers}")
            trigger = f.chunk if f.kind == "drop_result" else f.after_chunk
            if trigger is not None and not 0 <= trigger < num_chunks:
                raise ValueError(
                    f"fault {f.kind} triggers on chunk {trigger}, job has "
                    f"{num_chunks} chunks per worker")


class FaultLedger:
    """Chronological record of injected faults and master-side observations.

    Entries are plain dicts (JSON-friendly, they land verbatim on
    ``ExecutionReport.fault_ledger``): ``{"t": seconds since job start,
    "kind": ..., "worker": ...}`` plus kind-specific detail.  Terminal
    entries (crash/drop/deadline) gain ``equations_recovered`` /
    ``equations_lost`` when ``run_proc_job`` finalizes the ledger against
    the consumed chunk prefixes.
    """

    def __init__(self):
        self.t0 = time.perf_counter()
        self.entries: list[dict] = []
        self._lock = threading.Lock()  # injector timers record concurrently

    def record(self, kind: str, worker: int, **detail) -> dict:
        entry = {"t": round(time.perf_counter() - self.t0, 6),
                 "kind": kind, "worker": int(worker), **detail}
        with self._lock:
            self.entries.append(entry)
        return entry

    def workers(self) -> list[int]:
        with self._lock:
            return sorted({e["worker"] for e in self.entries})

    def summary(self) -> dict:
        """Compact rollup for ``ExecutionReport.decode_stats['faults']``."""
        with self._lock:
            by_kind: dict[str, int] = {}
            for e in self.entries:
                by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
            return {
                "events": len(self.entries),
                "by_kind": by_kind,
                "workers": sorted({e["worker"] for e in self.entries}),
                "equations_lost": sum(e.get("equations_lost", 0)
                                      for e in self.entries),
                "equations_recovered": sum(e.get("equations_recovered", 0)
                                           for e in self.entries),
            }


class FaultInjector:
    """Executes a ``FaultPlan`` against live worker pids (master side).

    The pool calls ``on_spawn`` when a worker's hello arrives (pid known),
    ``should_drop``/``on_result`` per chunk arrival, and ``shutdown`` when
    the job ends.  Every fault fires at most once, so a respawned worker is
    not re-killed by the fault that already claimed its predecessor.
    """

    def __init__(self, plan: FaultPlan, ledger: FaultLedger):
        self.plan = plan
        self.ledger = ledger
        self._pids: dict[int, int] = {}
        self._fired: set[int] = set()          # indices into plan.faults
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._paused_pids: set[int] = set()

    # ------------------------------ triggers ------------------------------

    def on_spawn(self, worker: int, pid: int) -> None:
        self._pids[worker] = pid
        for i, f in self._pending(worker):
            if f.kind == "slow":
                self._fired.add(i)
                self.ledger.record("slow", worker, factor=f.factor, pid=pid)
                t = threading.Thread(target=self._throttle,
                                     args=(pid, f.factor), daemon=True)
                t.start()
                self._threads.append(t)
            elif f.after_chunk is None and f.kind in ("kill", "pause"):
                self._fire(i, f, pid)

    def on_result(self, worker: int, chunk: int) -> None:
        pid = self._pids.get(worker)
        if pid is None:  # pragma: no cover - hello always precedes chunks
            return
        for i, f in self._pending(worker):
            if f.kind in ("kill", "pause") and f.after_chunk == chunk:
                self._fire(i, f, pid)

    def should_drop(self, worker: int, chunk: int) -> bool:
        for i, f in self._pending(worker):
            if f.kind == "drop_result" and f.chunk == chunk:
                self._fired.add(i)
                self.ledger.record("drop_result", worker, chunk=chunk)
                return True
        return False

    def _pending(self, worker: int):
        return [(i, f) for i, f in enumerate(self.plan.faults)
                if f.worker == worker and i not in self._fired]

    def _fire(self, i: int, f: Fault, pid: int) -> None:
        self._fired.add(i)
        if f.kind == "kill":
            self.ledger.record("kill", f.worker, after_chunk=f.after_chunk,
                               pid=pid)
            _signal(pid, signal.SIGKILL)
        elif f.kind == "pause":
            self.ledger.record("pause", f.worker, after_chunk=f.after_chunk,
                               duration=f.duration, pid=pid)
            if _signal(pid, signal.SIGSTOP):
                self._paused_pids.add(pid)
                if f.duration is not None:
                    t = threading.Thread(
                        target=self._resume_later,
                        args=(f.worker, pid, f.duration), daemon=True)
                    t.start()
                    self._threads.append(t)

    # ----------------------------- machinery ------------------------------

    def _resume_later(self, worker: int, pid: int, duration: float) -> None:
        if self._stop.wait(duration):
            return  # shutdown resumes every paused pid itself
        if _signal(pid, signal.SIGCONT):
            self._paused_pids.discard(pid)
            self.ledger.record("resume", worker, pid=pid)

    def _throttle(self, pid: int, factor: float) -> None:
        """Duty-cycle SIGSTOP/SIGCONT: run one slice, freeze factor-1."""
        while not self._stop.wait(SLOW_SLICE):
            if not _signal(pid, signal.SIGSTOP):
                return
            stopped = self._stop.wait(SLOW_SLICE * (factor - 1.0))
            if not _signal(pid, signal.SIGCONT):
                return
            if stopped:
                return

    def shutdown(self) -> None:
        """Stop throttle/timer threads and unfreeze every paused pid so the
        pool can terminate its processes cleanly."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)
        for pid in list(self._paused_pids) + list(self._pids.values()):
            _signal(pid, signal.SIGCONT)


def _signal(pid: int, sig) -> bool:
    try:
        os.kill(pid, sig)
        return True
    except (ProcessLookupError, PermissionError):
        return False


# --------------------- the simulator twin of a plan -------------------------

@dataclasses.dataclass
class FaultRealization(StragglerModel):
    """The same fault plan on the simulator's chunk timeline.

    ``run_coded_job`` with this model predicts the recovery behaviour of the
    realization ``run_proc_job`` executes for real: every worker serves its
    chunks at unit rate (scaled by ``unit_block_time``), then the plan edits
    the timeline --

    * ``slow``        -> the worker's per-chunk durations stretch by factor;
    * ``kill``        -> chunks after ``after_chunk`` never arrive (+inf);
    * ``pause``       -> chunks after the trigger shift by ``duration``
                         (+inf when the pause never ends);
    * ``drop_result`` -> the dropped chunk and everything after it never
                         arrive (the ordered stream is severed at the loss).

    The master's decodable-prefix rule then yields the predicted recovery
    point, with the identical arrival-set semantics the process pool's event
    source enforces.
    """

    plan: FaultPlan = dataclasses.field(default_factory=FaultPlan)

    def chunk_completion_times(self, work, rng):
        work = np.asarray(work, dtype=np.float64)
        if work.ndim != 2:
            raise ValueError(f"work must be (N, q), got shape {work.shape}")
        durations = work.copy()
        shifts = np.zeros_like(work)
        cut = np.full(work.shape[0], work.shape[1] + 1)  # first never-arriving chunk
        for f in self.plan.faults:
            w = f.worker
            if w >= work.shape[0]:
                raise ValueError(
                    f"fault targets worker {w}, realization has "
                    f"{work.shape[0]}")
            if f.kind == "slow":
                durations[w] *= f.factor
            elif f.kind == "kill":
                first = 0 if f.after_chunk is None else f.after_chunk + 1
                cut[w] = min(cut[w], first)
            elif f.kind == "pause":
                first = 0 if f.after_chunk is None else f.after_chunk + 1
                if f.duration is None:
                    cut[w] = min(cut[w], first)
                else:
                    shifts[w, first:] += f.duration
            elif f.kind == "drop_result":
                cut[w] = min(cut[w], f.chunk)
        times = np.cumsum(durations, axis=1) + shifts
        for w in range(work.shape[0]):
            if cut[w] <= work.shape[1]:
                times[w, int(cut[w]):] = np.inf
        return times

    def completion_times(self, nominal, rng):
        nominal = np.asarray(nominal, dtype=np.float64)
        return self.chunk_completion_times(nominal[:, None], rng)[:, -1]
