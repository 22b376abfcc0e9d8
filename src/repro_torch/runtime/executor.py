"""Master/worker execution of a coded matrix-multiplication job.

ONE master event loop (``_consume_events``) consumes
``(time, worker, chunk, payload)`` arrivals from pluggable event sources and
stops at the first decodable chunk prefix.  Decodability is gated per event
by an incremental rank tracker (``core.decoder.IncrementalRankTracker``,
O(mn * rank) per arrival) and confirmed with the exact scheme test only when
the tracker first fills.  Tasks are chunk-granular
(``CodeInstance.chunked(q)``): a straggler that finished q' < q of its
ordered sub-tasks still contributes q' usable equations (the
partial-straggler protocol); ``num_chunks=1`` is the paper's atomic
protocol, same arrivals, same decode.

The loop, the event sources and the seeded simulation are the JAX
package's, so a seeded run consumes the same arrivals and makes the same
decisions.  The blocks are torch tensors, dense or sparse CSR, on one
device: the CUDA card unless the caller passes ``device="cpu"``.  Numpy
and scipy blocks are moved there once, when a job starts; A's blocks are
held with their transposes made once (``core.blocks.HeldA``).  Every
decode time ends at a synchronisation of that device.

Entry points:

* ``run_coded_job`` -- event-driven simulation.  Chunk completion times are
  drawn from (per-chunk nominal work x straggler model); the master replays
  arrivals in time order, materializing worker results lazily on the
  device, and the decode (the paper's hybrid decoder) is timed for real.

* ``run_live_job`` -- actually-concurrent execution on real threads with
  injected sleeps: each worker computes its chunk products on the device
  on a CUDA stream of its own, which first waits for the job's blocks to
  be made (the caller's may still be in flight), and synchronises it
  before it posts ``(worker, chunk, payload)``, so an arrival means the
  product exists and was made from finished inputs.
  A worker that hangs past ``timeout`` surfaces as a ``DecodingError``
  naming the silent workers; a worker thread that exits early (exception,
  stop flag) posts a terminal sentinel.

* ``JobMux`` -- many concurrent jobs over one worker pool (``"sim"`` or
  ``"live"``), each decoded at its own first decodable prefix.

* ``run_device_job`` -- the device path: a thin timing wrapper over
  ``repro_torch.coded.CodedOp`` (workers one after the other on one card,
  the decode fused into the SpMM kernel's epilogue).
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import queue
import threading
import time
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.blocks import (
    blocks_to_device,
    hold_a_blocks,
    resolve_device,
    synchronize,
    transposed,
    zeros_like_block,
)
from repro_torch.core.decoder import DecodingError, IncrementalRankTracker
from repro_torch.core.encoder import encode_blocks, make_tasks
from repro_torch.core.schemes import ChunkedCode, CodeInstance


@dataclasses.dataclass
class ExecutionReport:
    scheme: str
    workers_used: int
    num_workers: int
    sim_compute_time: float       # simulated time until decodable set arrived
    decode_wall_time: float       # measured wall time of the decode
    total_time: float             # sim_compute_time + decode_wall_time
    decode_stats: dict
    blocks: list | None = None    # torch tensors on the job's device
    num_chunks: int = 1           # sub-tasks per worker (1 = atomic protocol)
    chunks_used: int = 0          # chunk arrivals consumed before decoding
    #: chronological fault ledger (process runtime): one dict per observed or
    #: injected fault.  Empty for the thread/sim/device paths.
    fault_ledger: list = dataclasses.field(default_factory=list)
    #: chunks consumed from each worker before decoding (host paths; None
    #: on the device path, where every live worker runs)
    worker_progress: list | None = None

    def summary(self) -> str:
        chunks = (f" ({self.chunks_used} chunks, q={self.num_chunks})"
                  if self.num_chunks > 1 else "")
        faults = (f" [{len(self.fault_ledger)} fault events]"
                  if self.fault_ledger else "")
        return (f"{self.scheme}: waited {self.workers_used}/{self.num_workers} workers"
                f"{chunks}, "
                f"compute {self.sim_compute_time:.4f}s + decode {self.decode_wall_time:.4f}s "
                f"= {self.total_time:.4f}s{faults}")


# --------------------------- the master event loop ---------------------------

class _EventSourceDry(Exception):
    """An event source gave up early (e.g. live queue timeout); the master
    decides whether the collected chunks decode anyway."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclasses.dataclass
class _MasterState:
    """What the shared loop hands back: everything needed to decode."""

    pairs: list[tuple[int, int]]          # (worker, chunk) in arrival order
    progress: np.ndarray                  # (N,) chunks consumed per worker
    results_by_row: dict[int, object]     # expanded-M row id -> block payload
    stop_time: float                      # event time of the decisive arrival
    exact_checks: int = 0                 # scheme-exact decodability tests run
    tracker_rows: int = 0                 # rows folded into the rank tracker
    tracker_rank: int = 0                 # tracker rank at stop

    def decode_stats(self, faults: dict | None = None) -> dict:
        """The host-path ``ExecutionReport.decode_stats`` payload."""
        return {
            "arrivals_consumed": len(self.pairs),
            "tracker_rows": self.tracker_rows,
            "tracker_rank": self.tracker_rank,
            "exact_checks": self.exact_checks,
            "faults": faults or {},
        }


@dataclasses.dataclass
class _JobProgress:
    """Per-job master state while the job is still in flight."""

    chunked: ChunkedCode
    tracker: IncrementalRankTracker
    progress: np.ndarray
    results_by_row: dict[int, object]
    pairs: list[tuple[int, int]]
    last_time: float = 0.0
    exact_checks: int = 0

    @classmethod
    def fresh(cls, chunked: ChunkedCode) -> "_JobProgress":
        return cls(chunked=chunked,
                   tracker=IncrementalRankTracker(chunked.mn),
                   progress=np.zeros(chunked.num_workers, dtype=np.int64),
                   results_by_row={}, pairs=[])

    def to_state(self, stop_time: float) -> _MasterState:
        return _MasterState(
            pairs=self.pairs, progress=self.progress,
            results_by_row=self.results_by_row, stop_time=stop_time,
            exact_checks=self.exact_checks,
            tracker_rows=self.tracker.rows_seen,
            tracker_rank=self.tracker.rank)


def _consume_mux_events(
    jobs: dict[int, ChunkedCode],
    events: Iterator[tuple[float, int, int, int, dict[int, object]]],
    job_done=None,
) -> tuple[dict[int, _MasterState], dict[int, str]]:
    """THE master loop, job-multiplexed: many jobs, one arrival stream.

    Each event is ``(time, worker, job, chunk, payload)`` with ``payload``
    mapping expanded-M row ids (of that job's code) to blocks; chunks of
    one (worker, job) stream must arrive in order.  Per event, that job's
    rank tracker folds in the new rows; the exact (scheme-specific)
    decodability test runs only once its tracker reports full rank.  A job
    that decodes stops consuming immediately and ``job_done(jid)`` tells
    the source to cancel its not-yet-started chunks -- other jobs keep
    draining.  Arrivals for finished or unknown jobs are skipped.

    Returns ``(states, failures)``: decodable jobs' ``_MasterState`` and,
    for jobs that never became decodable, the reason string.
    """
    live = {jid: _JobProgress.fresh(chunked) for jid, chunked in jobs.items()}
    states: dict[int, _MasterState] = {}
    failures: dict[int, str] = {}
    dry_reason: str | None = None
    try:
        for t, w, jid, c, payload in events:
            jp = live.get(jid)
            if jp is None:  # finished job's late chunk / stale batch leftover
                continue
            if c != jp.progress[w]:
                raise ValueError(
                    f"worker {w} delivered chunk {c} out of order "
                    f"(expected {jp.progress[w]}): sub-task streams are ordered")
            jp.progress[w] += 1
            jp.pairs.append((w, c))
            jp.last_time = t
            for r, blk in payload.items():
                jp.results_by_row[r] = blk
                jp.tracker.add(np.asarray(jp.chunked.M[r].todense()))
            if jp.tracker.is_full:
                jp.exact_checks += 1
                if jp.chunked.can_decode(jp.pairs):
                    states[jid] = jp.to_state(stop_time=t)
                    del live[jid]
                    if job_done is not None:
                        job_done(jid)
                    if not live:
                        break
    except _EventSourceDry as dry:
        dry_reason = dry.reason
    # events exhausted (or the source dried up): the tracker is a float
    # gate, so give the exact test the last word before declaring failure
    for jid, jp in live.items():
        jp.exact_checks += 1
        if jp.chunked.can_decode(jp.pairs):
            states[jid] = jp.to_state(stop_time=jp.last_time)
            continue
        if dry_reason is None:
            failures[jid] = (f"{jp.chunked.name}: not decodable even with all "
                             f"{jp.chunked.num_workers} workers' chunks")
        else:
            never = np.flatnonzero(jp.progress == 0).tolist()
            stalled = np.flatnonzero(
                (jp.progress > 0)
                & (jp.progress < jp.chunked.num_chunks)).tolist()
            failures[jid] = (
                f"{jp.chunked.name}: {dry_reason}; workers {never} never "
                f"reported" + (f", workers {stalled} stalled mid-stream"
                               if stalled else ""))
    return states, failures


def _consume_events(
    chunked: ChunkedCode,
    events: Iterator[tuple[float, int, int, dict[int, object]]],
) -> _MasterState:
    """Single-job master loop: the one-job view of ``_consume_mux_events``.

    Each event is ``(time, worker, chunk, payload)``.  Raises
    ``DecodingError`` with the job's failure reason when the collected
    chunks never decode.
    """
    def tagged():
        for t, w, c, payload in events:
            yield t, w, 0, c, payload

    states, failures = _consume_mux_events({0: chunked}, tagged())
    if 0 in states:
        return states[0]
    raise DecodingError(failures[0])


def _timed_decode(chunked: ChunkedCode, state: _MasterState,
                  device: torch.device):
    """The decode and its wall time, ended at a synchronisation of the
    device (the decode's torch ops return before the card finishes)."""
    t0 = time.perf_counter()
    blocks = chunked.decode(state.pairs, state.results_by_row)
    synchronize(device)
    return blocks, time.perf_counter() - t0


# ------------------------------ event sources -------------------------------

def _chunk_result(chunked: ChunkedCode, row: int, blocks_true: Sequence):
    """Exact payload of one expanded-M row (simulation path), computed
    lazily at arrival time so simulation cost tracks events consumed."""
    M = chunked.M
    lo, hi = M.indptr[row], M.indptr[row + 1]
    acc = None
    for c, w in zip(M.indices[lo:hi], M.data[lo:hi]):
        term = blocks_true[c] * float(w)
        acc = term if acc is None else acc + term
    if acc is None:  # empty chunk row (filtered upstream, but stay safe)
        acc = zeros_like_block(blocks_true[0])
    return acc


def _sim_events(
    chunked: ChunkedCode,
    blocks_true: Sequence,
    times: np.ndarray,
) -> Iterator[tuple[float, int, int, dict[int, object]]]:
    """Arrivals in simulated-time order; payloads materialize on consume.

    ``times``: (N, q) chunk completion times (rows nondecreasing).  The
    stable flat argsort keeps each worker's chunks in order under ties.
    """
    q = chunked.num_chunks
    order = np.argsort(times, axis=None, kind="stable")
    for flat in order:
        w, c = divmod(int(flat), q)
        payload = {r: _chunk_result(chunked, r, blocks_true)
                   for r in chunked.expanded_rows(w, c)}
        yield float(times[w, c]), w, c, payload


def _live_events(
    q_: "queue.Queue",
    num_workers: int,
    num_chunks: int,
    timeout: float,
    t0: float,
) -> Iterator[tuple[float, int, int, dict[int, object]]]:
    """Arrivals drained from the worker threads' queue (wall-clock times).

    The source expects ``num_chunks`` arrivals per worker but *learns* of
    terminal worker failure: a worker thread that exits posts the sentinel
    ``(w, None, error)``, which zeroes its outstanding count (``error`` is
    what it raised, or None).  A dry queue past ``timeout`` means some
    worker hung without exiting: signal the master loop, which names the
    silent/stalled workers in a ``DecodingError``.
    """
    outstanding = np.full(num_workers, num_chunks, dtype=np.int64)
    exited_early: list[int] = []
    errors: list[str] = []
    while int(outstanding.sum()) > 0:
        try:
            w, c, payload = q_.get(timeout=timeout)
        except queue.Empty:
            raise _EventSourceDry(
                f"no worker result within {timeout:.1f}s and the collected "
                "chunks do not decode (hung or dead workers?)") from None
        if c is None:  # terminal sentinel: worker w will deliver nothing more
            if outstanding[w] > 0:
                exited_early.append(int(w))
                outstanding[w] = 0
            if payload is not None:
                errors.append(f"worker {w}: {payload}")
            continue
        outstanding[w] -= 1
        yield time.perf_counter() - t0, w, c, payload
    if exited_early:
        raise _EventSourceDry(
            f"worker thread(s) {sorted(set(exited_early))} exited before "
            "delivering all chunks" + (f" ({'; '.join(errors)})" if errors else ""))


def _worker_stream(device: torch.device):
    """A CUDA stream of the worker thread's own (None on the CPU)."""
    return torch.cuda.Stream(device=device) if device.type == "cuda" else None


def _inputs_ready(device: torch.device):
    """An event recorded on the master's current stream once a job's blocks
    are staged there (None on the CPU).  The caller's blocks, and the
    transposes ``hold_a_blocks`` queues, may still be in flight; a worker
    stream waits on this event before its first product, so no worker
    reads a block before it is made."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


# ------------------------------ job multiplexer -----------------------------

@dataclasses.dataclass
class MuxJob:
    """One coded matmul job submitted to a ``JobMux`` pool.

    ``A_blocks``/``B_blocks`` are the column blocks of A and B (the job is
    C = A^T B over an (m, n) block grid, exactly as in ``run_live_job``);
    ``code.num_workers`` may be <= the pool size -- the job runs on the
    pool's first ``num_workers`` workers and leaves the rest to other jobs.
    ``tag`` is the caller's correlation key (e.g. a request id) and is
    echoed on the ``MuxResult``.
    """

    code: CodeInstance
    A_blocks: Sequence
    B_blocks: Sequence
    n: int
    num_chunks: int = 1
    tag: object = None


@dataclasses.dataclass
class MuxResult:
    """Outcome of one ``MuxJob``: a per-job report or a failure reason."""

    tag: object
    report: ExecutionReport | None
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def blocks(self):
        return self.report.blocks if self.report is not None else None


class _LazyTrueBlocks:
    """``blocks_true[i*n+j] = A_i^T B_j``, materialized on first touch so
    simulation cost tracks blocks actually referenced by consumed events."""

    def __init__(self, A_blocks: Sequence, B_blocks: Sequence, n: int):
        self._A, self._B, self._n = A_blocks, B_blocks, n
        self._cache: dict[int, object] = {}

    def __len__(self) -> int:
        return len(self._A) * self._n

    def __getitem__(self, k: int):
        out = self._cache.get(k)
        if out is None:
            i, j = divmod(k, self._n)
            out = self._cache[k] = transposed(self._A[i]) @ self._B[j]
        return out


def _fair_worker_items(
    chunkeds: dict[int, ChunkedCode], worker: int,
) -> list[tuple[int, int]]:
    """Chunk-major round-robin schedule for one worker: chunk 0 of every
    job (in submission order), then chunk 1 of every job, ...  No job's
    second chunk is computed before every job got its first."""
    jids = [jid for jid, ch in chunkeds.items() if worker < ch.num_workers]
    if not jids:
        return []
    maxq = max(chunkeds[jid].num_chunks for jid in jids)
    return [(jid, c) for c in range(maxq) for jid in jids
            if c < chunkeds[jid].num_chunks]


class _MuxSimSource:
    """Discrete-event simulation of one worker pool serving many jobs.

    Each worker is a rate-r server draining its fair chunk-major item queue
    in order; the straggler realization (one draw at pool construction, so
    the same worker stays slow across batches) sets the rates.  A job the
    master finished is cancelled: its not-yet-started items are skipped for
    free, its in-flight items complete and arrive as discarded late chunks.
    """

    def __init__(self, num_workers: int, straggler=None,
                 rng: np.random.Generator | None = None,
                 unit_block_time: float = 1.0,
                 dead_workers: Sequence[int] = ()):
        rng = rng or np.random.default_rng(0)
        base = np.ones(num_workers, dtype=np.float64)
        times = (straggler.completion_times(base, rng)
                 if straggler is not None else base)
        self.rates = 1.0 / np.asarray(times, dtype=np.float64)
        self.rates[list(dead_workers)] = 0.0
        self.num_workers = num_workers
        self.unit_block_time = unit_block_time
        self._done: set[int] = set()

    def start(self) -> None:
        pass

    def close(self) -> None:
        pass

    def job_done(self, jid: int) -> None:
        self._done.add(jid)

    def submit(self, chunkeds: dict[int, ChunkedCode],
               jobs: dict[int, MuxJob]):
        truth = {jid: _LazyTrueBlocks(j.A_blocks, j.B_blocks, j.n)
                 for jid, j in jobs.items()}
        work = {jid: ch.chunk_work() * self.unit_block_time
                for jid, ch in chunkeds.items()}
        return self._events(chunkeds, truth, work)

    def _events(self, chunkeds, truth, work):
        items = {w: _fair_worker_items(chunkeds, w)
                 for w in range(self.num_workers) if self.rates[w] > 0}
        heap: list[tuple[float, int, int, int, int]] = []
        ptr = {w: 0 for w in items}
        clock = {w: 0.0 for w in items}
        seq = 0

        def schedule(w: int) -> None:
            nonlocal seq
            while ptr[w] < len(items[w]):
                jid, c = items[w][ptr[w]]
                ptr[w] += 1
                if jid in self._done:  # cancelled before start: free skip
                    continue
                clock[w] += work[jid][w, c] / self.rates[w]
                heapq.heappush(heap, (clock[w], seq, w, jid, c))
                seq += 1
                return

        for w in items:
            schedule(w)
        while heap:
            t, _, w, jid, c = heapq.heappop(heap)
            if jid not in self._done:  # in-flight at cancel -> discard late
                ch = chunkeds[jid]
                payload = {r: _chunk_result(ch, r, truth[jid])
                           for r in ch.expanded_rows(w, c)}
                yield t, w, jid, c, payload
            schedule(w)


class _MuxLiveSource:
    """One persistent pool of worker threads serving batch after batch.

    Threads are spawned once (``start``) and park on a condition variable
    between batches; ``submit`` publishes a new epoch with per-worker fair
    item queues.  Workers check the shared done-set before every item, so a
    job the master finished stops costing compute mid-batch.  Each worker
    computes on a CUDA stream of its own, which waits for the batch's
    blocks to be made, and synchronises it before it posts a chunk.  Workers in ``dead_workers`` are never spawned, and the
    batch's event stream ends by naming them (and any worker that raised).
    """

    def __init__(self, num_workers: int, device: torch.device,
                 straggler_sleep: dict[int, float] | None = None,
                 dead_workers: Sequence[int] = (),
                 timeout: float = 60.0):
        self.num_workers = num_workers
        self.device = device
        self.straggler_sleep = straggler_sleep or {}
        self.dead = sorted(set(int(w) for w in dead_workers))
        self.timeout = timeout
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._cv = threading.Condition()
        self._epoch = 0
        # (items_by_worker, jobdata, inputs-ready event)
        self._batch: tuple[dict, dict, object] | None = None
        self._done: set[int] = set()
        self._threads: list[threading.Thread] = []

    def start(self) -> None:
        if self._threads:
            return
        self._threads = [
            threading.Thread(target=self._worker_fn, args=(w,), daemon=True,
                             name=f"mux-worker-{w}")
            for w in range(self.num_workers) if w not in self.dead]
        for t in self._threads:
            t.start()

    def close(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        join_deadline = time.perf_counter() + 5.0
        for t in self._threads:
            t.join(timeout=max(0.0, join_deadline - time.perf_counter()))
        self._threads = []

    def job_done(self, jid: int) -> None:
        self._done.add(jid)

    def submit(self, chunkeds: dict[int, ChunkedCode],
               jobs: dict[int, MuxJob]):
        items = {w: _fair_worker_items(chunkeds, w)
                 for w in range(self.num_workers)}
        jobdata = {}
        for jid, job in jobs.items():
            tasks_by_row = {t.worker: t for t in make_tasks(job.code.M)}
            jobdata[jid] = (job, tasks_by_row, chunkeds[jid].num_chunks)
        ready = _inputs_ready(self.device)  # after the jobs' blocks were staged
        with self._cv:
            self._epoch += 1
            self._batch = (items, jobdata, ready)
            epoch = self._epoch
            self._cv.notify_all()
        return self._events(epoch)

    def _worker_fn(self, w: int) -> None:
        stream = _worker_stream(self.device)
        last_seen = 0
        while True:
            with self._cv:
                self._cv.wait_for(
                    lambda: self._stop.is_set() or self._epoch > last_seen)
                if self._stop.is_set():
                    return
                last_seen = self._epoch
                items, jobdata, ready = self._batch
            if stream is not None:
                stream.wait_event(ready)  # the batch's blocks are made first
            my_items = items.get(w, [])
            row_chunks: dict[int, dict] = {}  # jid -> {row: chunks}
            error = None
            try:
                for jid, c in my_items:
                    if self._stop.is_set():
                        return
                    if jid in self._done:
                        continue
                    job, tasks_by_row, q = jobdata[jid]
                    if jid not in row_chunks:
                        row_chunks[jid] = {r: tasks_by_row[r].chunks(q)
                                           for r in job.code.worker_rows[w]}
                    delay = self.straggler_sleep.get(w, 0.0) / q
                    if delay and self._stop.wait(delay):  # interruptible
                        return
                    payload = {}
                    with _on(stream):
                        for r, chunks in row_chunks[jid].items():
                            out = encode_blocks(chunks[c], job.A_blocks,
                                                job.B_blocks, job.n)
                            if out is not None:
                                payload[r * q + c] = out
                    if stream is not None:
                        stream.synchronize()  # the product exists on arrival
                    self._q.put(("chunk", last_seen, w, jid, c, payload))
            except Exception as exc:  # the fin below reports it to the master
                error = repr(exc)
            finally:
                self._q.put(("fin", last_seen, w, None, None, error))

    def _events(self, epoch: int):
        t0 = time.perf_counter()
        fins: set[int] = set()
        errors: list[str] = []
        expected = self.num_workers - len(self.dead)
        while len(fins) < expected:
            try:
                kind, ep, w, jid, c, payload = self._q.get(
                    timeout=self.timeout)
            except queue.Empty:
                raise _EventSourceDry(
                    f"no worker result within {self.timeout:.1f}s and the "
                    "collected chunks do not decode (hung or dead workers?)"
                ) from None
            if ep != epoch:  # leftover of a previous batch: drop
                continue
            if kind == "fin":
                fins.add(w)
                if payload is not None:
                    errors.append(f"worker {w}: {payload}")
                continue
            yield time.perf_counter() - t0, w, jid, c, payload
        if self.dead:
            raise _EventSourceDry(
                f"worker(s) {self.dead} dead for the whole batch")
        if errors:
            raise _EventSourceDry(f"worker(s) raised: {'; '.join(errors)}")


class JobMux:
    """Many concurrent coded jobs multiplexed over ONE worker pool.

    The pool is persistent: construct once (picking the event source --
    ``"sim"`` for the rate-based discrete-event simulation, ``"live"`` for
    real threads with injected sleeps), then call :meth:`run` per batch of
    jobs.  Every batch shares the workers fairly (chunk-major round-robin
    across jobs), tracks decodability per job with its own
    ``IncrementalRankTracker``, stops each job at its first decodable
    chunk prefix, and cancels that job's remaining chunks.  One
    undecodable job fails alone (``MuxResult.error``); the rest of the
    batch decodes.

    ``device`` (None = the CUDA card, raising where there is none; or
    ``"cpu"``) is where every job's blocks live and are decoded; a job's
    numpy/scipy blocks are moved there once, when the job starts.
    """

    def __init__(self, num_workers: int, *, source: str = "sim",
                 straggler=None, rng: np.random.Generator | None = None,
                 unit_block_time: float = 1.0,
                 straggler_sleep: dict[int, float] | None = None,
                 dead_workers: Sequence[int] = (),
                 timeout: float = 60.0, device=None):
        self.num_workers = num_workers
        self.device = resolve_device(device)
        if source == "sim":
            self._source = _MuxSimSource(
                num_workers, straggler=straggler, rng=rng,
                unit_block_time=unit_block_time, dead_workers=dead_workers)
        elif source == "live":
            self._source = _MuxLiveSource(
                num_workers, self.device, straggler_sleep=straggler_sleep,
                dead_workers=dead_workers, timeout=timeout)
        else:
            raise ValueError(f"unknown JobMux source {source!r}; expected "
                             "'sim' or 'live'")
        self._next_jid = 0
        self._started = False

    def start(self) -> "JobMux":
        if not self._started:
            self._source.start()
            self._started = True
        return self

    def close(self) -> None:
        if self._started:
            self._source.close()
            self._started = False

    def __enter__(self) -> "JobMux":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def run(self, jobs: Sequence[MuxJob],
            raise_on_error: bool = False) -> list[MuxResult]:
        """Run one batch of concurrent jobs to per-job exact decode."""
        self.start()
        for job in jobs:
            if job.code.num_workers > self.num_workers:
                raise ValueError(
                    f"job {job.tag!r} wants {job.code.num_workers} workers "
                    f"but the pool has {self.num_workers}")
        jids = list(range(self._next_jid, self._next_jid + len(jobs)))
        self._next_jid += len(jobs)
        by_jid = {jid: dataclasses.replace(
                      job, A_blocks=hold_a_blocks(job.A_blocks, self.device),
                      B_blocks=blocks_to_device(job.B_blocks, self.device))
                  for jid, job in zip(jids, jobs)}
        chunkeds = {jid: job.code.chunked(job.num_chunks)
                    for jid, job in by_jid.items()}
        events = self._source.submit(chunkeds, by_jid)
        states, failures = _consume_mux_events(
            chunkeds, events, job_done=self._source.job_done)

        from repro_torch.runtime import pack_cache

        results = []
        for jid in jids:
            job = by_jid[jid]
            if jid in failures:
                if raise_on_error:
                    raise DecodingError(failures[jid])
                results.append(MuxResult(tag=job.tag, report=None,
                                         error=failures[jid]))
                continue
            state = states[jid]
            chunked = chunkeds[jid]
            blocks, decode_time = _timed_decode(chunked, state, self.device)
            stats = state.decode_stats()
            stats["concurrent_jobs"] = len(jobs)
            stats["pack_cache"] = pack_cache.cache_stats()
            results.append(MuxResult(tag=job.tag, report=ExecutionReport(
                scheme=chunked.name,
                workers_used=int((state.progress > 0).sum()),
                num_workers=job.code.num_workers,
                sim_compute_time=float(state.stop_time),
                decode_wall_time=decode_time,
                total_time=float(state.stop_time) + decode_time,
                decode_stats=stats,
                blocks=blocks,
                num_chunks=job.num_chunks,
                chunks_used=len(state.pairs),
                worker_progress=state.progress.tolist(),
            )))
        return results


# ------------------------------- entry points -------------------------------

def run_coded_job(
    code: CodeInstance,
    blocks_true: Sequence,
    straggler,
    rng: np.random.Generator | None = None,
    unit_block_time: float = 1.0,
    check_every: int = 1,
    keep_blocks: bool = False,
    num_chunks: int = 1,
    device=None,
) -> ExecutionReport:
    """Event-driven simulation of one job under a straggler realization
    (a ``runtime.straggler`` model).

    ``blocks_true`` are the mn block products, moved once to ``device``
    (None = the CUDA card, raising where there is none; or ``"cpu"``),
    where the workers' payloads are made and decoded.  ``num_chunks`` > 1
    runs the chunk-granular protocol.  ``check_every`` is retained for API
    compatibility; the incremental rank tracker makes it unnecessary.
    """
    del check_every  # superseded by the incremental rank tracker
    device = resolve_device(device)
    blocks_true = blocks_to_device(blocks_true, device)
    rng = rng or np.random.default_rng(0)
    chunked = code.chunked(num_chunks)
    work = chunked.chunk_work() * unit_block_time
    times = straggler.chunk_completion_times(work, rng)

    state = _consume_events(chunked, _sim_events(chunked, blocks_true, times))
    blocks, decode_time = _timed_decode(chunked, state, device)

    return ExecutionReport(
        scheme=chunked.name,
        workers_used=int((state.progress > 0).sum()),
        num_workers=code.num_workers,
        sim_compute_time=float(state.stop_time),
        decode_wall_time=decode_time,
        total_time=float(state.stop_time) + decode_time,
        decode_stats=state.decode_stats(),
        blocks=blocks if keep_blocks else None,
        num_chunks=num_chunks,
        chunks_used=len(state.pairs),
        worker_progress=state.progress.tolist(),
    )


def run_live_job(
    code: CodeInstance,
    A_blocks: Sequence,
    B_blocks: Sequence,
    n: int,
    straggler_sleep: dict[int, float] | None = None,
    num_threads: int = 4,
    num_chunks: int = 1,
    timeout: float = 60.0,
    device=None,
) -> ExecutionReport:
    """Concurrent execution with real block products and injected sleeps.

    Each worker thread computes its coded combination chunk by chunk (real
    products on ``device``: None = the CUDA card, raising where there is
    none; or ``"cpu"``), on a CUDA stream of its own that waits for the
    job's blocks to be made and that it synchronises before it pushes ``(worker, chunk, payload)`` to the master's queue; an
    injected sleep is spread evenly across the chunks.  The master consumes
    through the shared event loop and stops at the first decodable chunk
    prefix.  Workers observe the stop flag before *every* product and sleep
    interruptibly, and the master joins them with a bounded timeout before
    returning.  A worker that raises exits through its terminal sentinel.
    """
    del num_threads  # one thread per worker, as the protocol prescribes
    device = resolve_device(device)
    A_blocks = hold_a_blocks(A_blocks, device)
    B_blocks = blocks_to_device(B_blocks, device)
    ready = _inputs_ready(device)
    straggler_sleep = straggler_sleep or {}
    chunked = code.chunked(num_chunks)
    q_: queue.Queue = queue.Queue()
    stop = threading.Event()

    tasks_by_row = {t.worker: t for t in make_tasks(code.M)}  # row id -> task

    def worker_fn(w: int):
        delay = straggler_sleep.get(w, 0.0) / num_chunks
        row_chunks = {r: tasks_by_row[r].chunks(num_chunks)
                      for r in code.worker_rows[w]}
        stream = _worker_stream(device)
        if stream is not None:
            stream.wait_event(ready)  # the job's blocks are made first
        error = None
        try:
            for c in range(num_chunks):
                if delay and stop.wait(delay):  # interruptible sleep
                    return
                payload = {}
                with _on(stream):
                    for r, chunks in row_chunks.items():
                        if stop.is_set():
                            return
                        out = encode_blocks(chunks[c], A_blocks, B_blocks, n)
                        if out is not None:
                            payload[r * num_chunks + c] = out
                if stream is not None:
                    stream.synchronize()  # the product exists on arrival
                if stop.is_set():
                    return
                q_.put((w, c, payload))
        except Exception as exc:  # the sentinel below reports it
            error = repr(exc)
        finally:
            q_.put((w, None, error))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker_fn, args=(w,), daemon=True,
                                name=f"live-worker-{w}")
               for w in range(code.num_workers)]
    for t in threads:
        t.start()

    try:
        state = _consume_events(
            chunked, _live_events(q_, code.num_workers, num_chunks,
                                  timeout, t0))
    finally:
        stop.set()
        # bounded join: stop-aware workers exit after at most one more block
        # product (sleeps wake immediately on stop); the daemon flag stays as
        # the backstop for a truly wedged one
        join_deadline = time.perf_counter() + 5.0
        for t in threads:
            t.join(timeout=max(0.0, join_deadline - time.perf_counter()))
    compute_time = time.perf_counter() - t0

    blocks, decode_time = _timed_decode(chunked, state, device)

    return ExecutionReport(
        scheme=chunked.name,
        workers_used=int((state.progress > 0).sum()),
        num_workers=code.num_workers,
        sim_compute_time=compute_time,
        decode_wall_time=decode_time,
        total_time=compute_time + decode_time,
        decode_stats=state.decode_stats(),
        blocks=blocks,
        num_chunks=num_chunks,
        chunks_used=len(state.pairs),
        worker_progress=state.progress.tolist(),
    )


def _event_timed(fn, device: torch.device) -> tuple[object, float]:
    """fn() and its time in seconds: CUDA events around it on the card,
    ended at the stop event's synchronisation; the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
        return out, start.elapsed_time(stop) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def run_device_job(
    A,
    B,
    plan,
    device=None,
    backend: str = "dense_scan",
    survivors=None,
    repeats: int = 3,
    a_sparse=None,
    out_sharded: bool = False,
) -> ExecutionReport:
    """One coded matmul on one device (a thin ``CodedOp`` wrapper).

    A, B: (s, r) / (s, t) arrays or tensors.  ``plan`` is a
    ``repro_torch.core.coded_matmul.CodedMatmulPlan``; ``device`` (None =
    the CUDA card, raising where there is none; or ``"cpu"``) takes the
    place of the JAX package's mesh.  All execution policy lives in
    ``repro_torch.coded.CodedOp``: backend dispatch, BlockELL packing, the
    pack cache (hit when a caller-supplied ``a_sparse`` recurs), and
    survivor rebinding -- ``survivors`` may be an (N,) liveness mask or an
    (N, q) per-chunk completion mask.  One warm-up apply runs outside the
    timed region; the report's time is the median of ``repeats`` applies,
    each timed with CUDA events on the card.  The decode is fused into the
    device work, so decode_wall_time is 0.  ``blocks`` holds C as the
    device tensor, not a host copy.
    """
    from repro_torch.coded import CodedMatmulConfig, from_plan
    from repro_torch.core.coded_matmul import _host_f32
    from repro_torch.runtime import pack_cache
    from repro_torch.sparse.blocksparse import dense_to_block_ell

    cfg = CodedMatmulConfig(backend=backend, out_sharded=out_sharded)
    op = from_plan(cfg, plan).bind(device)
    if survivors is not None:
        op = op.with_survivors(survivors)

    kw = {}
    if op.needs_pack:
        # a caller-supplied a_sparse goes through the op's pack cache
        # (identity-keyed, so recurring ells hit); a freshly built BlockELL
        # bypasses it -- caching it would only pin dead entries
        if a_sparse is not None:
            kw["pack"] = op.pack_for(a_sparse)
        else:
            ell = dense_to_block_ell(_host_f32(A),
                                     block_size=op.config.block_size)
            kw["pack"] = op.pack_for(ell, use_cache=False)
    A = torch.as_tensor(A, dtype=torch.float32, device=op.device)
    B = torch.as_tensor(B, dtype=torch.float32, device=op.device)
    op.apply(A, B, **kw)  # warm-up: outside the timed region
    synchronize(op.device)
    times = []
    result = None
    for _ in range(max(1, repeats)):
        result, seconds = _event_timed(lambda: op.apply(A, B, **kw), op.device)
        times.append(seconds)
    elapsed = float(np.median(times))

    used = (int(op.survivors.sum()) if op.survivors is not None
            else plan.num_workers)
    return ExecutionReport(
        scheme=f"spmd_{backend}",
        workers_used=used,
        num_workers=plan.num_workers,
        sim_compute_time=elapsed,
        decode_wall_time=0.0,
        total_time=elapsed,
        decode_stats={"backend": backend, "max_degree": plan.max_degree,
                      "on_device_decode": True, "out_sharded": out_sharded,
                      "pack_cache": pack_cache.cache_stats()},
        blocks=[result],
    )
