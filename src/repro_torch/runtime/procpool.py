"""Out-of-process worker pool: real subprocesses, real faults, one protocol.

``run_live_job`` runs workers as daemon threads -- they share a GIL and a
fate, so a "straggler" is an injected sleep and a "dead worker" is a thought
experiment.  This module promotes workers to OS subprocesses
with per-worker pipes and serializes their ``(worker, chunk, payload)``
arrivals into the SAME master loop (``runtime.executor._consume_events``)
the simulator and the thread runtime feed -- only the transport changed.
What the process boundary buys (DESIGN.md section 10):

* workers can actually crash (SIGKILL mid-chunk -> pipe EOF + exit code),
  hang (SIGSTOP freezes compute *and* heartbeats), or genuinely run slow
  (duty-cycled SIGSTOP/SIGCONT) -- see ``runtime.chaos`` for the fault plan
  language;
* the master grows the robustness a thread pool never needed: per-worker
  heartbeats with a deadline (an overdue worker stops being waited on but
  its late arrivals still count), crash detection via pipe EOF + exit code,
  optional one-shot respawn that reassigns a dead worker's remaining chunk
  suffix to a fresh process, and graceful degradation to decoding from
  whatever ordered chunk prefixes survived;
* every fault -- injected or observed -- lands in a ``FaultLedger`` that
  ``ExecutionReport.fault_ledger`` exposes, with terminal entries accounting
  equations lost vs recovered.

The workers compute on the master's device: each process opens it (the
CUDA card unless the caller asked for the CPU) and makes one small dense
and one small CSR product there before it says hello, so its CUDA context
and library handles count as start-up, as interpreter start-up does, and
never against the heartbeat deadline.  A worker that cannot open the
device, or that raises, reports the error and the job ends with it: no
worker falls back to the CPU.  Each worker synchronises the device before
it sends a chunk, so an arrival means the product exists, and a throttled
worker (``slow``) delivers slowly although the card runs on.

Blocks cross the pipes as plain host arrays, never as torch tensors:
``import torch`` registers torch's reductions with multiprocessing's
pickler, so a CPU tensor would travel as a shared-memory fd that the
receiver fetches from the sender while it unpickles (a frozen sender hangs
the master, a killed one turns a delivered chunk into a crash), and a CUDA
tensor as an IPC handle whose memory dies with its process.  ``to_wire``
makes a dense block ``("dense", array)`` and a CSR block ``("csr", crow,
col, val, shape)``; ``from_wire`` puts one on a device.  A is sent with
its blocks transposed once on the host, and each worker gets only the
blocks its rows use; the master moves each payload to its device once, on
arrival.

Workers start from a fork server (``_context``): one process that imports
torch and this module once, and that every worker is forked from, so a
pool of 28 workers pays torch's import once instead of 28 times on the
host's cores.  The server never touches a device; each worker opens its
own after the fork.

Start-up is kept out of the job's clock.  A ``ProcPool`` worker receives
its job with its operands, puts them on the device, says hello and then
waits for ``go``, which the master sends once every worker said hello or
ended (``timeout`` bounds the wait); ``MuxProcPool.start`` waits for every
hello before a batch is sent.  A ``WorkerProcesses`` keeps a pool's
processes for the next job (``run_proc_job(processes=)``), so only the
first job pays their start-up.  The master opens its own device before ``go``
(``_warm_device``), since it moves every arriving chunk there.  Spawn-to-hello times are reported apart
(``decode_stats["startup"]``).

Wire format (pickled tuples; per worker one simplex pipe each way).
Master -> worker messages are sent by a thread of their own (``_Outbox``),
so the master never blocks on a worker that is slow to read, frozen or
dead.  ``ProcPool``: master -> worker ``("job", w, row_chunks, ...,
A_blocks, B_blocks)`` then ``("go",)``, and ``("stop",)`` at the job's end
where the process is kept; worker -> master ``("hello", w, pid, startup)``
once a job, ``("hb", w)`` every heartbeat interval from a daemon thread
(beats keep flowing during a long chunk but stop when the process is
frozen or dead), ``("chunk", w, c, payload)`` per completed chunk in
order, ``("done", w)`` after the last, ``("idle", w)`` on ``stop``,
``("error", w, text)`` when it raised.  Pipe EOF without ``done`` is a
crash, whatever the exit code says.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import queue
import threading
import time
import warnings
from multiprocessing import connection as mp_connection
from multiprocessing import forkserver as mp_forkserver
from multiprocessing import resource_tracker as mp_resource_tracker
from multiprocessing import util as mp_util

import numpy as np
import torch

from repro_torch.core.blocks import (
    HeldA,
    blocks_to_device,
    hold_a_blocks,
    is_csr,
    resolve_device,
    synchronize,
)
from repro_torch.core.encoder import encode_blocks, make_tasks
from repro_torch.core.schemes import CodeInstance
from repro_torch.runtime.chaos import FaultInjector, FaultLedger, FaultPlan
from repro_torch.runtime.executor import (
    ExecutionReport,
    _EventSourceDry,
    _consume_events,
    _fair_worker_items,
    _timed_decode,
)

#: master poll cadence, seconds: the wait() timeout between liveness sweeps
_POLL = 0.02

#: what the fork server imports before it forks a worker: torch and the
#: workers' own code (none of it opens a device when imported)
_PRELOAD = ["numpy", "scipy.sparse", "torch", "repro_torch.runtime.procpool"]


#: the pid of the process that set ``stop_fork_server`` to run at its exit
_server_owner: int | None = None


def _context():
    """The worker processes' start method: a fork server with ``_PRELOAD``
    imported.  The server is a fresh interpreter, started once for the
    process and never given a device, so a fork of it holds no CUDA
    context or thread; the worker re-imports the caller's main module, as
    a spawned one does.  ``stop_fork_server`` runs at exit."""
    global _server_owner
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    if _server_owner != os.getpid():
        _server_owner = os.getpid()
        # priority below 0: after multiprocessing has joined the workers;
        # above -100: before it removes the temporary directory that holds
        # the server's socket
        mp_util.Finalize(None, stop_fork_server, exitpriority=-50)
    return ctx


def stop_fork_server() -> None:
    """Stop the fork server and the resource tracker it holds open, and wait
    until both have exited; the next pool starts them again.

    Left alone, the server outlives its program: it exits on the EOF of a
    pipe the program closes as it ends, and then takes torch's interpreter
    shutdown.  So this runs at exit, once multiprocessing has joined the
    workers; call it sooner to have both gone sooner.  Raises while a worker
    still runs."""
    if _server_owner != os.getpid():
        return
    live = multiprocessing.active_children()
    if live:
        raise RuntimeError("worker processes still running: "
                           + ", ".join(p.name for p in live))
    mp_forkserver._forkserver._stop()
    mp_resource_tracker._resource_tracker._stop()


# -------------------------------- wire format --------------------------------

def to_wire(x: torch.Tensor) -> tuple:
    """One block as plain host arrays: ``("dense", array)`` or ``("csr",
    crow, col, val, shape)``, copied to the host where it lies elsewhere."""
    x = x.detach().cpu()
    if is_csr(x):
        return ("csr", x.crow_indices().numpy(), x.col_indices().numpy(),
                x.values().numpy(), tuple(x.shape))
    if x.layout != torch.strided:
        raise ValueError(f"block layout {x.layout} is neither dense nor CSR")
    return ("dense", x.numpy())


def from_wire(msg: tuple, device: torch.device) -> torch.Tensor:
    """The block ``to_wire`` made, as a tensor on ``device``."""
    if msg[0] == "csr":
        _, crow, col, val, shape = msg
        return torch.sparse_csr_tensor(
            torch.from_numpy(crow), torch.from_numpy(col),
            torch.from_numpy(val), size=shape,
            check_invariants=False).to(device)
    return torch.from_numpy(msg[1]).to(device)


def _wire_operands(A_blocks, B_blocks) -> tuple[list, list]:
    """A's blocks transposed (once, on the host) and B's blocks, as wire
    tuples."""
    cpu = torch.device("cpu")
    return ([to_wire(a.T) for a in hold_a_blocks(A_blocks, cpu)],
            [to_wire(b) for b in blocks_to_device(B_blocks, cpu)])


def _worker_operands(A_wire: list, B_wire: list, tasks, n: int):
    """The blocks of A and B that ``tasks`` use, keyed by block index."""
    cols = {int(c) for t in tasks for c in t.cols}
    return ({i: A_wire[i] for i in sorted({c // n for c in cols})},
            {j: B_wire[j] for j in sorted({c % n for c in cols})})


def _operands_on(dev: torch.device, A_wire: dict, B_wire: dict):
    A_blocks = {i: HeldA(from_wire(a, dev)) for i, a in A_wire.items()}
    B_blocks = {j: from_wire(b, dev) for j, b in B_wire.items()}
    return A_blocks, B_blocks


def _encode_chunk(row_chunks: dict, c: int, q: int, A_blocks, B_blocks,
                  n: int, dev: torch.device) -> dict:
    """One chunk's payload, made on ``dev``, synchronised (so it exists
    when it is sent) and put into wire tuples."""
    payload = {}
    for r, chunks in row_chunks.items():
        out = encode_blocks(chunks[c], A_blocks, B_blocks, n)
        if out is not None:
            payload[r * q + c] = out
    synchronize(dev)
    return {k: to_wire(v) for k, v in payload.items()}


class _Outbox:
    """Master -> worker messages, sent in order by a daemon thread that
    owns the pipe's write end: the master never blocks on a worker that is
    slow to read, frozen or dead.  ``close`` lets the thread send what is
    queued, then close the pipe."""

    def __init__(self, conn, name: str):
        self._conn = conn
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        threading.Thread(target=self._run, daemon=True, name=name).start()

    def put(self, msg) -> None:
        self._q.put(msg)

    def close(self) -> None:
        self._q.put(None)

    def _run(self) -> None:
        try:
            while (msg := self._q.get()) is not None:
                self._conn.send(msg)
        except (BrokenPipeError, OSError):
            pass  # the worker is gone: the master reads its EOF
        finally:
            self._conn.close()


# ------------------------------- worker side --------------------------------

def _warm_device(dev: torch.device) -> None:
    """One small dense and one small CSR product on ``dev``, synchronised:
    CUDA's context and its library handles exist after it.  The workers
    make them before their hello, the master after the hellos and before
    ``go``: the master
    moves every arriving chunk to the device, and a context made then
    (over a second on an H100) would hold the arrivals back until the
    workers' streams had all come in, and be counted as compute."""
    eye = torch.eye(2, device=dev)
    eye @ eye
    csr = eye.to_sparse_csr()
    csr @ csr
    synchronize(dev)


def _open_device(device: str) -> torch.device:
    """The worker's device, opened (``_warm_device``) before the worker says
    hello.  Raises where the device cannot be opened."""
    # torch's once-per-process notices, which every worker would repeat
    warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
    warnings.filterwarnings("ignore", "Sparse invariant checks are implicitly")
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the pool's workers share the host's cores
    _warm_device(dev)
    return dev


def _worker_main(inbox, conn, device, t_spawn):
    """Subprocess entry point (process target; must stay module-level).

    Opens the device once, then serves jobs until the master goes away.  A
    job is ``("job", w, row_chunks, n, num_chunks, start_chunk,
    chunk_sleep, hb_interval, A_wire, B_wire)``: the worker puts its
    operands on the device, says hello, and on ``go`` computes worker
    ``w``'s ordered chunk stream exactly like the thread runtime's
    ``worker_fn``, sending each result over ``conn``, then ``done``.  A
    ``("stop",)`` -- during a job, between two chunks or in a straggler's
    sleep, or after it -- ends the job, and the worker answers ``("idle",
    w)``.  A daemon heartbeat thread shares ``conn`` under a lock and beats
    from hello to the job's end: beats prove the *process* is scheduled,
    independent of chunk progress.  The first hello carries the worker's
    start-up: seconds from ``t_spawn`` (the master's ``time.time()`` at the
    spawn) to this function, to open the device, to put its operands
    there; a later one the operands' seconds alone.
    """
    t_entry = time.time()
    send_lock = threading.Lock()
    stop_hb = threading.Event()  # the running job's beats
    w = None

    def _send(msg) -> bool:
        try:
            with send_lock:
                conn.send(msg)
            return True
        except (BrokenPipeError, OSError, ValueError):
            return False  # master went away: nothing left to report to

    def _beat(stop, w, interval):
        while not stop.wait(interval):
            if not _send(("hb", w)):
                return

    def _stopped(timeout: float = 0.0) -> bool:
        """Whether ``("stop",)`` came within ``timeout`` seconds (taken)."""
        if inbox.poll(timeout):
            inbox.recv()
            return True
        return False

    try:
        dev = _open_device(device)
        startup = {"entry_s": t_entry - t_spawn, "device_s": time.time() - t_entry}
        while True:
            msg = inbox.recv()
            if msg[0] == "stop":  # no job under way
                _send(("idle", None))
                continue
            (_, w, row_chunks, n, num_chunks, start_chunk, chunk_sleep,
             hb_interval, A_wire, B_wire) = msg
            t_job = time.time()
            A_blocks, B_blocks = _operands_on(dev, A_wire, B_wire)
            synchronize(dev)
            _send(("hello", w, os.getpid(), {**startup, "operands_s": time.time() - t_job}))
            startup = {}
            stop_hb = threading.Event()
            threading.Thread(target=_beat, args=(stop_hb, w, hb_interval), daemon=True).start()
            stopped = inbox.recv()[0] == "stop"  # else ("go",): the job's clock starts
            for c in range(start_chunk, num_chunks):
                if stopped or _stopped(chunk_sleep):
                    stopped = True
                    break
                payload = _encode_chunk(row_chunks, c, num_chunks, A_blocks,
                                        B_blocks, n, dev)
                if not _send(("chunk", w, c, payload)):
                    return
            if not stopped:
                _send(("done", w))
                stopped = _stopped(None)
            stop_hb.set()
            _send(("idle", w))
    except EOFError:
        return  # master went away
    except Exception as exc:  # the master ends the job with it (no CPU fallback)
        _send(("error", w, repr(exc)))
    finally:
        stop_hb.set()
        inbox.close()
        conn.close()


def _start_worker(ctx, device: torch.device, name: str):
    """One worker process (``_worker_main``) forked from the fork server:
    the process, the read end of its pipe to the master, and its
    ``_Outbox``."""
    inbox_r, inbox_w = ctx.Pipe(duplex=False)
    recv_end, send_end = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_worker_main,
                       args=(inbox_r, send_end, str(device), time.time()),
                       daemon=True, name=name)
    proc.start()
    send_end.close()  # keep only the child's copy: EOF tracks its death
    inbox_r.close()
    return proc, recv_end, _Outbox(inbox_w, name=f"{name}-outbox")


def _end_worker(proc, conn, outbox, deadline: float) -> None:
    """Terminate a worker process (where it still runs), reap it by
    ``deadline`` (``time.perf_counter()``; then SIGKILL) and close its
    pipes."""
    if proc.is_alive():
        proc.terminate()
    proc.join(timeout=max(0.1, deadline - time.perf_counter()))
    if proc.is_alive():  # pragma: no cover - SIGKILL backstop
        proc.kill()
        proc.join(timeout=1.0)
    outbox.close()
    if conn is not None:
        conn.close()


class WorkerProcesses:
    """Worker processes kept from one ``run_proc_job`` to the next
    (``processes=``): each opens the device once, and ``ProcPool`` hands
    process k worker k's part of every job, so a job after the first pays
    no start-up but its operands' transfer.  Faults act on the processes
    as in a pool of its own: a process a fault ended, or one that does not
    answer ``stop`` within ``STOP_S`` once its job is over, is ended and
    replaced by a fresh one when its slot is next used.  ``close`` (or the
    ``with`` block's end) ends them all.

    ``device``: None = the CUDA card, raising where there is none; or
    ``"cpu"``.  Every job run on it must name the same device."""

    #: seconds a process has to answer ``stop`` at the end of a job
    STOP_S = 5.0

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._ctx = _context()
        self._idle: dict[int, tuple] = {}   # slot -> (proc, conn, outbox)
        self._closed = False

    def take(self, slot: int) -> tuple:
        """Slot ``slot``'s process, ready for a job (a fresh one where it
        has none): ``(proc, conn, outbox, fresh)``."""
        if self._closed:
            raise RuntimeError("WorkerProcesses is closed")
        if slot in self._idle:
            return (*self._idle.pop(slot), False)
        return (*_start_worker(self._ctx, self.device, f"proc-worker-{slot}"), True)

    def give_back(self, entries: dict) -> None:
        """``{slot: (proc, conn, outbox)}`` at a job's end: each is sent
        ``stop``; those that answer ``idle`` within ``STOP_S`` are kept for
        the next job, the others ended."""
        waiting = {}
        for slot, (proc, conn, outbox) in entries.items():
            if conn is None or not proc.is_alive():
                _end_worker(proc, conn, outbox, time.perf_counter())
                continue
            outbox.put(("stop",))
            waiting[conn] = (slot, proc, outbox)
        deadline = time.perf_counter() + self.STOP_S
        while waiting and time.perf_counter() < deadline:
            for conn in mp_connection.wait(list(waiting), timeout=_POLL):
                slot, proc, outbox = waiting[conn]
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    msg = ("eof",)
                if msg[0] == "idle":
                    del waiting[conn]
                    self._idle[slot] = (proc, conn, outbox)
                elif msg[0] in ("eof", "error"):
                    del waiting[conn]
                    _end_worker(proc, conn, outbox, time.perf_counter() + 1.0)
                # the job's late chunks, heartbeats and ``done``: dropped
        for conn, (_, proc, outbox) in waiting.items():
            _end_worker(proc, conn, outbox, time.perf_counter() + 1.0)

    def close(self) -> None:
        """End every process.  Idempotent."""
        self._closed = True
        deadline = time.perf_counter() + 5.0
        for proc, conn, outbox in self._idle.values():
            _end_worker(proc, conn, outbox, deadline)
        self._idle.clear()

    def __enter__(self) -> "WorkerProcesses":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------- master side --------------------------------

@dataclasses.dataclass
class _WorkerState:
    """Master-side view of one worker process's lifecycle."""

    proc: object
    conn: object                  # recv end; None once EOF'd/severed
    outbox: _Outbox
    spawned_at: float = 0.0       # perf_counter of the spawn
    pid: int | None = None
    last_seen: float = 0.0        # perf_counter of the last message
    next_chunk: int = 0           # next in-order chunk the master will accept
    done: bool = False            # clean "done" sentinel received
    dead: bool = False            # EOF before done (crash)
    overdue: bool = False         # missed the heartbeat deadline
    dropped: bool = False         # stream severed by a drop_result fault
    respawned: bool = False       # one-shot respawn already spent


class ProcPool:
    """Spawn-based worker pool whose ``events()`` iterator is a master-loop
    event source (the third transport after simulation and threads).

    ``device`` (None = the CUDA card, raising where there is none; or
    ``"cpu"``) is where the workers compute and the master decodes.
    """

    def __init__(self, code: CodeInstance, num_chunks: int,
                 A_blocks, B_blocks, n: int, *,
                 straggler_sleep: dict[int, float] | None = None,
                 heartbeat_interval: float = 0.05,
                 heartbeat_deadline: float = 2.0,
                 respawn: bool = False,
                 plan=None, device=None, processes: WorkerProcesses | None = None):
        self.device = resolve_device(device)
        if processes is not None and processes.device != self.device:
            raise ValueError(f"the processes run on {processes.device}, the job on "
                             f"{self.device}")
        self._processes = processes
        self.code = code
        self.num_chunks = int(num_chunks)
        self.n = n
        self.straggler_sleep = dict(straggler_sleep or {})
        self.hb_interval = float(heartbeat_interval)
        self.hb_deadline = float(heartbeat_deadline)
        self.respawn = bool(respawn)
        if self.hb_deadline <= self.hb_interval:
            raise ValueError("heartbeat_deadline must exceed the interval")

        self.ledger = FaultLedger()
        plan = FaultPlan.coerce(plan)
        plan.validate(code.num_workers, self.num_chunks)
        self.injector = FaultInjector(plan, self.ledger)

        self._ctx = _context()
        tasks_by_row = {t.worker: t for t in make_tasks(code.M)}
        A_wire, B_wire = _wire_operands(A_blocks, B_blocks)
        self._row_chunks, self._operands = {}, {}
        for w in range(code.num_workers):
            rows = code.worker_rows[w]
            self._row_chunks[w] = {r: tasks_by_row[r].chunks(self.num_chunks)
                                   for r in rows}
            self._operands[w] = _worker_operands(
                A_wire, B_wire, [tasks_by_row[r] for r in rows], n)
        self._workers: dict[int, _WorkerState] = {}
        self._retired: list[_WorkerState] = []   # respawned workers' dead predecessors
        self._t0: float | None = None   # the job's start: "go" sent
        #: start-up: seconds from spawn to "go", and each incarnation's
        #: hello in hello order: its worker, seconds from its spawn to its
        #: hello, and the split the worker reported (to its entry point,
        #: to open the device, to put its operands there)
        self.startup: dict = {"go_s": None, "hello": []}

    # ------------------------------ lifecycle -----------------------------

    def start(self, timeout: float = 60.0) -> float:
        """Spawn every worker, wait until each said hello or ended (at most
        ``timeout`` seconds), send ``go`` and return that moment: the job's
        start.  Raises when a worker reports an error."""
        t_spawn = time.perf_counter()
        self.ledger.t0 = t_spawn
        for w in range(self.code.num_workers):
            self._spawn(w, 0)
        while time.perf_counter() - t_spawn < timeout and any(
                st.conn is not None and st.pid is None
                for st in self._workers.values()):
            # every live worker is drained: heartbeats keep last_seen true
            conns = {st.conn: w for w, st in self._workers.items()
                     if st.conn is not None}
            for conn in mp_connection.wait(list(conns), timeout=_POLL):
                for _ in self._drain(conns[conn], time.perf_counter()):
                    pass  # no chunk comes before "go"
        _warm_device(self.device)
        self._t0 = time.perf_counter()
        self.startup["go_s"] = self._t0 - t_spawn
        for st in self._workers.values():
            st.outbox.put(("go",))
        return self._t0

    def _spawn(self, w: int, start_chunk: int, respawned: bool = False):
        """Worker ``w``'s process, sent its job: ``processes``'s process
        for slot ``w`` where the pool has them, else (and for a respawn) a
        fresh one."""
        if self._processes is not None and not respawned:
            proc, conn, outbox, _ = self._processes.take(w)
        else:
            proc, conn, outbox = _start_worker(self._ctx, self.device, f"proc-worker-{w}")
        if w in self._workers:  # a respawn: its dead predecessor's pipes
            self._retired.append(self._workers[w])
        chunk_sleep = self.straggler_sleep.get(w, 0.0) / self.num_chunks
        outbox.put(("job", w, self._row_chunks[w], self.n, self.num_chunks, start_chunk,
                    chunk_sleep, self.hb_interval, *self._operands[w]))
        now = time.perf_counter()
        self._workers[w] = _WorkerState(
            proc=proc, conn=conn, outbox=outbox, spawned_at=now,
            last_seen=now, next_chunk=start_chunk, respawned=respawned)
        if self._t0 is not None:  # a respawn: the job is under way
            outbox.put(("go",))

    def shutdown(self) -> None:
        """Injector off, every child unfrozen; then each process given back
        to ``processes`` (which keeps those that stop) or, without it,
        terminated and reaped; pipes closed.  Idempotent; safe after
        partial startup."""
        self.injector.shutdown()
        workers, self._workers = self._workers, {}
        retired, self._retired = self._retired, []
        deadline = time.perf_counter() + 5.0
        for st in retired:
            _end_worker(st.proc, st.conn, st.outbox, deadline)
        if self._processes is not None:
            self._processes.give_back({w: (st.proc, st.conn, st.outbox)
                                       for w, st in workers.items()})
            return
        for st in workers.values():
            if st.proc.is_alive():
                st.proc.terminate()
        for st in workers.values():
            _end_worker(st.proc, st.conn, st.outbox, deadline)

    # ----------------------------- event source ---------------------------

    def events(self, timeout: float):
        """Yield ``(time, worker, chunk, payload)`` for ``_consume_events``,
        times counted from ``go``, payloads on the pool's device.

        Ends (StopIteration) only when every worker delivered every chunk;
        raises ``_EventSourceDry`` when the survivors' arrivals are drained
        but some stream ended early (crash/drop/overdue), or when nothing
        arrives for ``timeout`` seconds -- the master then decides whether
        the collected prefixes decode anyway.
        """
        last_progress = time.perf_counter()
        while True:
            conns = {st.conn: w for w, st in self._workers.items()
                     if st.conn is not None}
            if conns:
                ready = mp_connection.wait(list(conns), timeout=_POLL)
            else:
                time.sleep(_POLL)
                ready = []
            now = time.perf_counter()
            for conn in ready:
                w = conns[conn]
                for evt in self._drain(w, now):
                    last_progress = time.perf_counter()
                    yield evt
            self._sweep_deadlines(time.perf_counter())
            if not self._expecting():
                shortfall = self._shortfall_reason()
                if shortfall:
                    raise _EventSourceDry(shortfall)
                return
            if time.perf_counter() - last_progress > timeout:
                raise _EventSourceDry(
                    f"no worker result within {timeout:.1f}s and the "
                    "collected chunks do not decode (hung or dead workers?)")

    def _drain(self, w: int, now: float):
        """Consume every buffered message of worker ``w``; yield its in-order
        chunk events.  EOF classifies the exit (done vs crash) only after the
        buffer is empty, so a respawn never resends a chunk the dead
        incarnation already delivered."""
        st = self._workers[w]
        while st.conn is not None and st.conn.poll():
            try:
                msg = st.conn.recv()
            except (EOFError, OSError, ValueError):
                self._on_eof(w, st, now)
                return
            st.last_seen = now
            tag = msg[0]
            if tag == "hello":
                st.pid = msg[2]
                self.startup["hello"].append(
                    {"worker": w, "hello_s": now - st.spawned_at, **msg[3]})
                self.injector.on_spawn(w, st.pid)
            elif tag == "chunk":
                _, _, c, payload = msg
                if st.dropped:
                    continue  # severed stream: later chunks are out of order
                if self.injector.should_drop(w, c):
                    st.dropped = True
                    continue
                st.next_chunk = c + 1
                self.injector.on_result(w, c)
                yield (now - self._t0, w, c,
                       {r: from_wire(b, self.device) for r, b in payload.items()})
            elif tag == "done":
                st.done = True
            elif tag == "error":
                raise RuntimeError(f"worker process {w} failed: {msg[2]}")
            # "hb" only refreshes last_seen, handled above

    def _on_eof(self, w: int, st: _WorkerState, now: float) -> None:
        st.conn.close()
        st.conn = None
        if st.done:
            return  # reaped at shutdown: a torch process takes a while to exit
        st.proc.join(timeout=0.5)  # for its exit code; the write end is gone
        st.dead = True
        self.ledger.record(
            "crash_detected", w, exitcode=st.proc.exitcode,
            next_chunk=st.next_chunk)
        if (self.respawn and not st.respawned
                and st.next_chunk < self.num_chunks):
            self.ledger.record("respawn", w, start_chunk=st.next_chunk)
            self._spawn(w, st.next_chunk, respawned=True)

    def _sweep_deadlines(self, now: float) -> None:
        for w, st in self._workers.items():
            # the deadline clock starts at hello: start-up in the child (pid
            # still unknown) must not read as a missed heartbeat
            if (st.conn is None or st.pid is None or st.done or st.overdue
                    or st.next_chunk >= self.num_chunks):
                continue
            if now - st.last_seen > self.hb_deadline:
                st.overdue = True
                self.ledger.record(
                    "deadline_missed", w,
                    silent_for=round(now - st.last_seen, 6),
                    next_chunk=st.next_chunk)

    def _expecting(self) -> bool:
        """Is any worker still worth waiting on?"""
        return any(
            st.conn is not None and not (st.done or st.overdue or st.dropped)
            and st.next_chunk < self.num_chunks
            for st in self._workers.values())

    def _shortfall_reason(self) -> str | None:
        """Human-readable cause when not every chunk arrived, else None."""
        crashed = sorted(w for w, st in self._workers.items() if st.dead)
        dropped = sorted(w for w, st in self._workers.items() if st.dropped)
        overdue = sorted(
            w for w, st in self._workers.items()
            if st.overdue and st.next_chunk < self.num_chunks)
        parts = []
        if crashed:
            parts.append(f"worker process(es) {crashed} crashed")
        if dropped:
            parts.append(f"result stream(s) of {dropped} severed by a "
                         "dropped message")
        if overdue:
            parts.append(f"worker(s) {overdue} missed the "
                         f"{self.hb_deadline:.1f}s heartbeat deadline")
        return "; ".join(parts) or None

    # ------------------------------ accounting ----------------------------

    def finalize_ledger(self, chunked, progress: np.ndarray) -> list[dict]:
        """Attach equations lost/recovered to terminal ledger entries.

        ``progress`` is the master's consumed-chunk count per worker; a
        terminal worker's recovered equations are the expanded-M rows of its
        consumed prefix, its lost equations the remaining nonempty rows.
        Only the *observed*-terminal kinds are annotated (the injected
        ``kill``/``pause`` that caused them would double-count).
        """
        for entry in self.ledger.entries:
            if entry["kind"] not in ("crash_detected", "drop_result",
                                     "deadline_missed"):
                continue
            w = entry["worker"]
            consumed = int(progress[w]) if w < len(progress) else 0
            recovered = sum(
                len(chunked.expanded_rows(w, c)) for c in range(consumed))
            total = sum(
                len(chunked.expanded_rows(w, c))
                for c in range(chunked.num_chunks))
            entry["equations_recovered"] = recovered
            entry["equations_lost"] = total - recovered
        return list(self.ledger.entries)


# --------------------------- job-multiplexed pool ---------------------------

def _mux_worker_main(worker, inbox, conn, device, t_spawn, sleep_per_chunk):
    """Persistent mux subprocess (process target; must stay module-level).

    Serves batch after batch.  Wire format: master -> worker (``inbox``)
    ``("batch", epoch, items, jobdata)`` with ``items`` a fair ``[(jid,
    chunk)]`` schedule and ``jobdata[jid] = (row_chunks, A_blocks,
    B_blocks, n, q)`` (the blocks as wire tuples, only those the worker's
    rows use, put on the device at the job's first item); ``("job_done",
    jid)`` cancels a job's not-yet-started chunks (the worker drains
    control messages before every item); ``("stop",)`` ends the process.
    worker -> master (``conn``) ``("hello", w, pid, startup)`` once the
    device is open (seconds from ``t_spawn`` to this function and to open
    the device), ``("chunk", w, epoch, jid, c, payload)`` per result in order,
    ``("fin", w, epoch)`` when its batch schedule is drained, ``("error",
    w, text)`` when it raised.  Pipe EOF without a fin is a crash, whatever
    the exit code says.
    """
    t_entry = time.time()
    try:
        try:
            dev = _open_device(device)
        except Exception as exc:  # the master ends the batch with it
            conn.send(("error", worker, repr(exc)))
            return
        conn.send(("hello", worker, os.getpid(), {
            "entry_s": t_entry - t_spawn, "device_s": time.time() - t_entry}))
        done = set()
        while True:
            msg = inbox.recv()
            if msg[0] == "stop":
                return
            if msg[0] == "job_done":
                done.add(msg[1])
                continue
            _, epoch, items, jobdata = msg
            blocks = {}  # jid -> its blocks on the device
            try:
                for jid, c in items:
                    while inbox.poll():  # control messages preempt the schedule
                        m2 = inbox.recv()
                        if m2[0] == "stop":
                            return
                        if m2[0] == "job_done":
                            done.add(m2[1])
                    if jid in done:
                        continue
                    row_chunks, A_wire, B_wire, n, q = jobdata[jid]
                    if jid not in blocks:
                        blocks[jid] = _operands_on(dev, A_wire, B_wire)
                    if sleep_per_chunk:
                        time.sleep(sleep_per_chunk / q)
                    payload = _encode_chunk(row_chunks, c, q, *blocks[jid],
                                            n, dev)
                    conn.send(("chunk", worker, epoch, jid, c, payload))
            except (EOFError, BrokenPipeError):
                raise  # master went away: handled below
            except Exception as exc:  # the master ends the batch with it
                conn.send(("error", worker, repr(exc)))
                return
            conn.send(("fin", worker, epoch))
    except (EOFError, OSError):
        return  # master went away: nothing left to report to
    finally:
        inbox.close()
        conn.close()


class MuxProcPool:
    """``JobMux`` event source over persistent OS subprocess workers.

    The third mux transport after ``_MuxSimSource`` and ``_MuxLiveSource``:
    construct a ``JobMux``-compatible source whose workers are real
    processes spawned ONCE (``start`` waits for every worker's hello) and
    reused batch after batch (pass the instance as ``JobMux(num_workers,
    source=pool)``, on the pool's device).  Faults are real: a
    ``runtime.chaos`` plan SIGKILLs or throttles live pids
    (``kill.after_chunk`` counts the worker's per-job chunk index of the
    arrival that triggers it), crashes surface as pipe EOF and land in
    ``self.ledger``, and later batches simply stop scheduling the dead
    worker -- coded jobs keep decoding, uncoded jobs that needed it fail
    alone.  Hangs are covered by the batch ``timeout`` (this pool has no
    heartbeat thread; use ``ProcPool`` for deadline semantics on single
    jobs).  ``device`` (None = the CUDA card, raising where there is none;
    or ``"cpu"``) is where the workers compute.
    """

    def __init__(self, num_workers: int, *,
                 straggler_sleep: dict[int, float] | None = None,
                 timeout: float = 60.0, plan=None, device=None):
        self.device = resolve_device(device)
        self.num_workers = int(num_workers)
        self.straggler_sleep = dict(straggler_sleep or {})
        self.timeout = float(timeout)
        self.ledger = FaultLedger()
        plan = FaultPlan.coerce(plan)
        for f in plan.faults:
            if f.worker >= self.num_workers:
                raise ValueError(f"fault {f.kind} targets worker {f.worker}, "
                                 f"pool has {self.num_workers}")
        self.injector = FaultInjector(plan, self.ledger)
        self._ctx = _context()
        self._conns: dict[int, object] = {}
        self._outboxes: dict[int, _Outbox] = {}
        self._procs: dict[int, object] = {}
        self._pids: dict[int, int] = {}
        self._crashed: set[int] = set()
        self._epoch = 0
        #: each worker's start-up: seconds from the spawn to its hello, and
        #: the split it reported (to its entry point, to open the device)
        self.startup: dict[int, dict] = {}

    def start(self) -> None:
        """Spawn every worker and wait (at most ``timeout`` seconds) until
        each said hello or ended.  Raises, pool closed, when a worker
        reports an error."""
        if self._procs:
            return
        t_spawn = self.ledger.t0 = time.perf_counter()
        for w in range(self.num_workers):
            inbox_r, inbox_w = self._ctx.Pipe(duplex=False)
            recv_end, send_end = self._ctx.Pipe(duplex=False)
            proc = self._ctx.Process(
                target=_mux_worker_main,
                args=(w, inbox_r, send_end, str(self.device), time.time(),
                      self.straggler_sleep.get(w, 0.0)),
                daemon=True, name=f"mux-proc-worker-{w}")
            proc.start()
            inbox_r.close()
            send_end.close()
            self._conns[w] = recv_end
            self._outboxes[w] = _Outbox(inbox_w, name=f"mux-outbox-{w}")
            self._procs[w] = proc
        try:
            while time.perf_counter() - t_spawn < self.timeout:
                waiting = {conn: w for w, conn in self._conns.items()
                           if conn is not None and w not in self._pids}
                if not waiting:
                    break
                for conn in mp_connection.wait(list(waiting), timeout=_POLL):
                    w = waiting[conn]
                    try:
                        msg = conn.recv()
                    except (EOFError, OSError):
                        self._sever(w)
                        continue
                    self._on_control(w, msg)
            _warm_device(self.device)
        except RuntimeError:
            self.close()
            raise

    def close(self) -> None:
        self.injector.shutdown()
        for outbox in self._outboxes.values():
            outbox.put(("stop",))
            outbox.close()
        deadline = time.perf_counter() + 5.0
        for w, proc in self._procs.items():
            proc.join(timeout=max(0.1, deadline - time.perf_counter()))
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=1.0)
            if proc.is_alive():  # pragma: no cover - SIGKILL backstop
                proc.kill()
                proc.join(timeout=1.0)
            if self._conns.get(w) is not None:
                self._conns[w].close()
                self._conns[w] = None
        self._procs = {}
        self._outboxes = {}

    def job_done(self, jid: int) -> None:
        for w, outbox in self._outboxes.items():
            if self._conns.get(w) is not None:
                outbox.put(("job_done", jid))

    def submit(self, chunkeds, jobs):
        self._epoch += 1
        jobrows = {}
        for jid, job in jobs.items():
            tasks_by_row = {t.worker: t for t in make_tasks(job.code.M)}
            jobrows[jid] = (job, tasks_by_row, chunkeds[jid].num_chunks,
                            _wire_operands(job.A_blocks, job.B_blocks))
        for w in range(self.num_workers):
            if self._conns.get(w) is None:
                continue
            items = _fair_worker_items(chunkeds, w)
            jobdata = {}
            for jid in {jid for jid, _ in items}:
                job, tasks_by_row, q, (A_wire, B_wire) = jobrows[jid]
                rows = job.code.worker_rows[w]
                row_chunks = {r: tasks_by_row[r].chunks(q) for r in rows}
                jobdata[jid] = (row_chunks, *_worker_operands(
                    A_wire, B_wire, [tasks_by_row[r] for r in rows], job.n),
                    job.n, q)
            self._outboxes[w].put(("batch", self._epoch, items, jobdata))
        return self._events(self._epoch)

    def _sever(self, w: int, proc_join: float | None = 0.5) -> None:
        conn = self._conns.get(w)
        if conn is not None:
            conn.close()
        self._conns[w] = None
        if w not in self._crashed:
            self._crashed.add(w)
            proc = self._procs.get(w)
            if proc is not None and proc_join is not None:
                proc.join(timeout=proc_join)
            self.ledger.record(
                "crash_detected", w,
                exitcode=proc.exitcode if proc is not None else None)

    def _on_control(self, w: int, msg) -> None:
        """A worker's hello (pid known: the injector may act on it) or its
        error (the batch ends with it)."""
        if msg[0] == "hello":
            self._pids[w] = msg[2]
            self.startup[w] = {"hello_s": time.perf_counter() - self.ledger.t0,
                               **msg[3]}
            self.injector.on_spawn(w, msg[2])
        elif msg[0] == "error":
            raise RuntimeError(f"worker process {w} failed: {msg[2]}")

    def _events(self, epoch: int):
        t0 = time.perf_counter()
        last_progress = t0
        fins: set[int] = set()
        while True:
            conns = {conn: w for w, conn in self._conns.items()
                     if conn is not None and w not in fins}
            if not conns:
                break
            ready = mp_connection.wait(list(conns), timeout=_POLL)
            for conn in ready:
                w = conns[conn]
                while self._conns.get(w) is not None and conn.poll():
                    try:
                        msg = conn.recv()
                    except (EOFError, OSError):
                        self._sever(w)
                        break
                    last_progress = time.perf_counter()
                    tag = msg[0]
                    if tag == "chunk":
                        _, _, ep, jid, c, payload = msg
                        if ep != epoch:  # cancelled leftovers of a past batch
                            continue
                        if self.injector.should_drop(w, c):
                            continue
                        self.injector.on_result(w, c)
                        yield (time.perf_counter() - t0, w, jid, c,
                               {r: from_wire(b, self.device)
                                for r, b in payload.items()})
                    elif tag == "fin":
                        if msg[2] == epoch:
                            fins.add(w)
                    else:
                        self._on_control(w, msg)
            if time.perf_counter() - last_progress > self.timeout:
                raise _EventSourceDry(
                    f"no worker result within {self.timeout:.1f}s and the "
                    "collected chunks do not decode (hung or dead workers?)")
        if self._crashed:
            raise _EventSourceDry(
                f"worker process(es) {sorted(self._crashed)} crashed")


# ------------------------------- entry point --------------------------------

def run_proc_job(
    code: CodeInstance,
    A_blocks,
    B_blocks,
    n: int,
    straggler_sleep: dict[int, float] | None = None,
    num_chunks: int = 1,
    timeout: float = 60.0,
    plan=None,
    heartbeat_interval: float = 0.05,
    heartbeat_deadline: float = 2.0,
    respawn: bool = False,
    device=None,
    processes: WorkerProcesses | None = None,
) -> ExecutionReport:
    """``run_live_job`` with real OS subprocesses and (optionally) real
    faults.

    Mirrors ``run_live_job``'s signature and semantics -- same blocks, same
    chunk-granular protocol, same first-decodable-prefix stop rule -- plus:

    ``plan``      a ``runtime.chaos`` fault plan (or list of faults) the
                  injector executes against the live worker pids;
    ``heartbeat_interval`` / ``heartbeat_deadline``
                  workers beat every interval; a worker silent past the
                  deadline stops being waited on (its late arrivals still
                  count if they show up);
    ``respawn``   one-shot recovery: a crashed worker's remaining chunk
                  suffix is reassigned to a fresh process resuming at the
                  next in-order chunk;
    ``device``    None = the CUDA card, raising where there is none; or
                  ``"cpu"``: where every worker process computes and the
                  master decodes;
    ``processes`` a ``WorkerProcesses`` whose processes serve the job and
                  stay for the next one (None: processes of the job's own,
                  ended with it).

    The compute time counts from ``go`` (every worker started) to the
    decodable prefix; start-up is in ``decode_stats["startup"]``.  The
    report carries the full fault ledger and a populated ``decode_stats``
    (arrivals, tracker rank, exact-test count, fault summary).  An
    unrecoverable fault set raises ``DecodingError`` naming the
    crashed/severed/overdue workers; a worker that raised (one that cannot
    open the device, say) raises ``RuntimeError`` naming it.

    A worker re-imports the caller's main module, so a script calling this
    from module scope needs the standard ``if __name__ == "__main__":``
    guard.
    """
    chunked = code.chunked(num_chunks)
    pool = ProcPool(
        code, num_chunks, A_blocks, B_blocks, n,
        straggler_sleep=straggler_sleep,
        heartbeat_interval=heartbeat_interval,
        heartbeat_deadline=heartbeat_deadline,
        respawn=respawn, plan=plan, device=device, processes=processes)
    try:
        t0 = pool.start(timeout)
        state = _consume_events(chunked, pool.events(timeout))
        compute_time = time.perf_counter() - t0
    finally:
        pool.shutdown()

    blocks, decode_time = _timed_decode(chunked, state, pool.device)
    ledger = pool.finalize_ledger(chunked, state.progress)
    stats = state.decode_stats(faults=pool.ledger.summary())
    stats["startup"] = pool.startup
    return ExecutionReport(
        scheme=chunked.name,
        workers_used=int((state.progress > 0).sum()),
        num_workers=code.num_workers,
        sim_compute_time=compute_time,
        decode_wall_time=decode_time,
        total_time=compute_time + decode_time,
        decode_stats=stats,
        blocks=blocks,
        num_chunks=num_chunks,
        chunks_used=len(state.pairs),
        fault_ledger=ledger,
        worker_progress=state.progress.tolist(),
    )
