"""The port's process runtime on the CPU: real worker processes, real faults.

``run_proc_job`` must decode through every fault class the chaos language
speaks -- kill, pause past the heartbeat deadline, slow, drop_result --
whenever the surviving chunk prefixes decode, must fail (naming the faulted
workers) when they do not, and must account every fault in the report's
ledger, as the JAX package's ``run_proc_job`` does on the same inputs.
``MuxProcPool`` under ``JobMux``: coded jobs decode past a killed worker,
an uncoded job that needs it fails alone.  Payloads cross the pipes as
plain host arrays (``to_wire``), so a worker frozen right after it sent a
chunk cannot hang the master.

Every decoded block is held to the dense float64 A^T B within 1e-8.  No
assertion reads a wall clock.  Each fault is sure to fire before the job
can decode: a worker's operands are in place before ``go``, the faulted
worker sleeps less than the others (or the fault fires at spawn), and the
heartbeat deadline is 5 s wherever the test is not about the deadline.
"""

from __future__ import annotations

import functools
import os
import signal
import threading
import time
from multiprocessing.reduction import ForkingPickler

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from repro.core import schemes as js  # noqa: E402
from repro.core.encoder import split_blocks  # noqa: E402
from repro.runtime import chaos as jc  # noqa: E402
from repro.runtime import procpool as jp  # noqa: E402

from repro_torch.core import blocks as pb  # noqa: E402
from repro_torch.core import schemes  # noqa: E402
from repro_torch.core.decoder import DecodingError  # noqa: E402
from repro_torch.core.encoder import make_tasks  # noqa: E402
from repro_torch.runtime import executor as px  # noqa: E402
from repro_torch.runtime import procpool  # noqa: E402
from repro_torch.runtime.chaos import drop_result, kill, pause, slow  # noqa: E402
from repro_torch.runtime.procpool import MuxProcPool, run_proc_job  # noqa: E402

M_SPLIT = N_SPLIT = 2
TOL = 1e-8
#: each worker's sleep over its q = 4 chunks: a faulted worker sleeps
#: FAULTED_S (its chunks 0 and 1 come 0.1 and 0.2 s after go), the others
#: OTHERS_S (the test code first decodes from 2 chunks a worker, 0.8 s
#: after go)
OTHERS_S, FAULTED_S = 1.6, 0.4
DEADLINE = 5.0


def _data(seed=0):
    A = sp.random(40, 16, density=0.3, format="csc",
                  random_state=np.random.RandomState(seed))
    B = sp.random(40, 20, density=0.3, format="csc",
                  random_state=np.random.RandomState(seed + 1))
    return A, B


def _dense(b) -> np.ndarray:
    if isinstance(b, torch.Tensor):
        return (b.to_dense() if pb.is_csr(b) else b).numpy()
    return b.toarray() if sp.issparse(b) else np.asarray(b)


def _assert_product(blocks, A, B):
    C = (A.T @ B).toarray()
    br, bt = C.shape[0] // M_SPLIT, C.shape[1] // N_SPLIT
    for i in range(M_SPLIT):
        for j in range(N_SPLIT):
            got = blocks[i * N_SPLIT + j]
            assert not isinstance(got, torch.Tensor) or got.dtype == torch.float64
            np.testing.assert_allclose(
                _dense(got), C[i * br:(i + 1) * br, j * bt:(j + 1) * bt],
                rtol=0, atol=TOL)


def _sleeps(num_workers, faulted=None, sleep=OTHERS_S):
    return {w: (FAULTED_S if w == faulted else sleep) for w in range(num_workers)}


def _run(code, plan, *, faulted=None, sleep=OTHERS_S, q=4, run=run_proc_job, **kw):
    A, B = _data()
    kw.setdefault("straggler_sleep", _sleeps(code.num_workers, faulted, sleep))
    kw.setdefault("heartbeat_deadline", DEADLINE)
    if run is run_proc_job:
        kw["device"] = "cpu"
    rep = run(code, split_blocks(A, M_SPLIT), split_blocks(B, N_SPLIT), N_SPLIT,
              num_chunks=q, plan=plan, timeout=60.0, **kw)
    return rep, A, B


MATRIX = {
    "kill": lambda: kill(1, after_chunk=0),
    "pause_past_deadline": lambda: pause(2, after_chunk=0),  # frozen until shutdown
    "slow10x": lambda: slow(3, factor=10.0),
    "drop_result": lambda: drop_result(1, chunk=1),
}


@functools.cache
def _matrix_run(name):
    """One run per fault class, shared by the tests that read it."""
    fault = MATRIX[name]()
    code = schemes.sparse_code(M_SPLIT, N_SPLIT, N=8, seed=4)
    rep, A, B = _run(code, [fault], faulted=fault.worker)
    return fault, rep, A, B


# ----------------------------- the chaos matrix -----------------------------

@pytest.mark.parametrize("name", sorted(MATRIX))
def test_chaos_matrix_recoverable_decodes_and_names_worker(name):
    """Each fault class, injected mid-stream on a redundant code: the job
    decodes the exact product and the ledger names the faulted worker."""
    fault, rep, A, B = _matrix_run(name)
    _assert_product(rep.blocks, A, B)
    assert all(b.layout == torch.sparse_csr for b in rep.blocks)
    faults = rep.decode_stats["faults"]
    assert fault.worker in faults["workers"]
    assert faults["by_kind"].get(fault.kind) == 1
    assert any(e["kind"] == fault.kind and e["worker"] == fault.worker
               for e in rep.fault_ledger)
    assert int(np.sum(rep.worker_progress)) == rep.chunks_used


def test_kill_at_spawn_unrecoverable_names_worker():
    """uncoded needs every worker: killing one before it delivers anything
    must raise DecodingError naming it, as the reference's does, word for
    word."""
    errors = []
    for mod, run in ((schemes, run_proc_job), (js, jp.run_proc_job)):
        with pytest.raises(DecodingError if mod is schemes else Exception,
                           match=r"\[1\].*never reported") as err:
            _run(mod.uncoded(M_SPLIT, N_SPLIT),
                 [(kill if mod is schemes else jc.kill)(1)], sleep=0.4, run=run)
        errors.append((type(err.value).__name__, str(err.value)))
    assert errors[0] == errors[1]
    assert "worker process(es) [1] crashed" in errors[0][1]


def test_pause_past_deadline_unrecoverable_fails_at_the_deadline():
    """A paused essential worker trips the heartbeat deadline: the master
    gives up at the deadline, not at the job's timeout, and names it."""
    code = schemes.uncoded(M_SPLIT, N_SPLIT)
    with pytest.raises(DecodingError, match=r"\[1\].*heartbeat deadline") as err:
        _run(code, [pause(1)], sleep=0.4, heartbeat_interval=0.05,
             heartbeat_deadline=2.0)
    assert "no worker result within" not in str(err.value)


def test_respawn_recovers_essential_worker():
    """One-shot respawn: the killed worker's chunks are reassigned to a
    fresh process, so even a code with zero redundancy completes."""
    code = schemes.uncoded(M_SPLIT, N_SPLIT)
    rep, A, B = _run(code, [kill(1)], sleep=0.4, respawn=True)
    _assert_product(rep.blocks, A, B)
    kinds = [e["kind"] for e in rep.fault_ledger]
    assert kinds == ["kill", "crash_detected", "respawn"]
    crash = rep.fault_ledger[1]
    assert crash["worker"] == 1 and crash["exitcode"] == -signal.SIGKILL
    # the respawned incarnation redelivered everything: nothing stayed lost
    assert crash["equations_lost"] == 0
    # five incarnations said hello: the four workers and the respawn
    hello = rep.decode_stats["startup"]["hello"]
    assert sorted(h["worker"] for h in hello) == [0, 1, 1, 2, 3]


def test_drop_result_severs_stream_and_accounts_equations():
    """A dropped chunk message severs the worker's ordered stream; the
    ledger accounts its consumed prefix vs the lost suffix."""
    _, rep, A, B = _matrix_run("drop_result")
    entry = next(e for e in rep.fault_ledger if e["kind"] == "drop_result")
    # sparse_code row of worker 1 spans chunks 0 and 1: chunk 0 was consumed
    # before the chunk-1 message was lost
    assert entry["equations_recovered"] == 1
    assert entry["equations_lost"] == 1
    faults = rep.decode_stats["faults"]
    assert faults["equations_lost"] == 1
    assert faults["equations_recovered"] == 1
    assert rep.worker_progress[1] == 1


def test_proc_job_decode_stats_populated():
    """The process path fills decode_stats like the host paths do, plus the
    fault summary rollup and the workers' start-up."""
    _, rep, _, _ = _matrix_run("kill")
    stats = rep.decode_stats
    code = schemes.sparse_code(M_SPLIT, N_SPLIT, N=8, seed=4)
    assert stats["arrivals_consumed"] == rep.chunks_used > 0
    assert stats["tracker_rank"] == code.mn
    assert stats["tracker_rows"] >= stats["tracker_rank"]
    assert stats["exact_checks"] >= 1
    assert stats["faults"]["workers"] == [1]
    startup = stats["startup"]
    assert sorted(h["worker"] for h in startup["hello"]) == list(range(8))
    for h in startup["hello"]:  # each split is a part of the spawn-to-hello time
        parts = (h["entry_s"], h["device_s"], h["operands_s"])
        assert all(p >= 0 for p in parts) and h["hello_s"] <= startup["go_s"]


@functools.cache
def _clean_run():
    code = schemes.sparse_code(M_SPLIT, N_SPLIT, N=6, seed=4)
    return _run(code, None, sleep=0.0, q=2)


def test_proc_job_no_faults_clean_run():
    """No plan: the pool is just a transport -- exact product, empty
    ledger, every worker used."""
    rep, A, B = _clean_run()
    _assert_product(rep.blocks, A, B)
    assert rep.fault_ledger == []
    assert rep.decode_stats["faults"]["events"] == 0


def test_proc_job_rejects_plan_outside_geometry():
    code = schemes.uncoded(M_SPLIT, N_SPLIT)
    A, B = _data()
    with pytest.raises(ValueError, match="targets worker 9"):
        run_proc_job(code, split_blocks(A, M_SPLIT), split_blocks(B, N_SPLIT),
                     N_SPLIT, num_chunks=2, plan=[kill(9)], device="cpu")
    with pytest.raises(ValueError, match="deadline must exceed"):
        run_proc_job(code, split_blocks(A, M_SPLIT), split_blocks(B, N_SPLIT),
                     N_SPLIT, heartbeat_deadline=0.01, device="cpu")


# ------------------------- against the reference ----------------------------

@pytest.mark.parametrize("case", ["no fault", "drop_result"])
def test_proc_job_agrees_with_reference(case):
    """The same inputs through the JAX package's run_proc_job: the same
    blocks (within 1e-8), ledger kinds and equation accounting."""
    if case == "no fault":
        got, A, B = _clean_run()
        want, _, _ = _run(js.sparse_code(M_SPLIT, N_SPLIT, N=6, seed=4), None,
                          sleep=0.0, q=2, run=jp.run_proc_job)
    else:
        _, got, A, B = _matrix_run("drop_result")
        want, _, _ = _run(js.sparse_code(M_SPLIT, N_SPLIT, N=8, seed=4),
                          [jc.drop_result(1, chunk=1)], faulted=1, run=jp.run_proc_job)
    _assert_product(want.blocks, A, B)
    for g, w in zip(got.blocks, want.blocks):
        np.testing.assert_allclose(_dense(g), _dense(w), rtol=0, atol=TOL)
    assert got.scheme == want.scheme and got.num_chunks == want.num_chunks
    terminal = ("crash_detected", "drop_result", "deadline_missed")

    def accounting(rep):
        return sorted((e["kind"], e["worker"], e.get("equations_recovered"),
                       e.get("equations_lost"))
                      for e in rep.fault_ledger if e["kind"] in terminal)

    assert accounting(got) == accounting(want)
    assert [e["kind"] for e in got.fault_ledger] == [e["kind"] for e in want.fault_ledger]


# ------------------------------ the wire format -----------------------------

def _csr(rng, shape, density, dtype):
    x = sp.random(*shape, density=density, format="csr", dtype=dtype,
                  random_state=np.random.RandomState(int(rng.integers(1 << 30))))
    return pb.to_device(x, torch.device("cpu"))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wire_carries_blocks_as_plain_arrays_unchanged(dtype):
    """A CSR block (empty rows and an all-empty block included) and a dense
    one go through to_wire, the pipes' pickler and from_wire unchanged:
    layout, shape, dtype, indices and values -- and the pickled bytes hold
    numpy arrays, no torch object."""
    rng = np.random.default_rng(3)
    blocks = [_csr(rng, (9, 7), 0.3, dtype), _csr(rng, (5, 4), 0.0, dtype),
              torch.from_numpy(rng.standard_normal((6, 3)).astype(dtype)),
              torch.from_numpy(rng.standard_normal((3, 6)).astype(dtype)).T]
    for x in blocks:
        wire = procpool.to_wire(x)
        arrays = wire[1:4] if wire[0] == "csr" else wire[1:]
        assert all(isinstance(a, np.ndarray) for a in arrays)
        raw = bytes(ForkingPickler.dumps(wire))
        assert b"torch" not in raw
        back = procpool.from_wire(ForkingPickler.loads(raw), torch.device("cpu"))
        assert back.layout == x.layout and back.shape == x.shape and back.dtype == x.dtype
        if pb.is_csr(x):
            for part in ("crow_indices", "col_indices", "values"):
                assert torch.equal(getattr(back, part)(), getattr(x, part)())
        else:
            assert torch.equal(back, x)


def test_worker_gets_only_the_blocks_its_rows_use():
    code = schemes.sparse_code(3, 3, 12, seed=2)
    A_wire = [("dense", np.full((1, 1), i)) for i in range(3)]
    B_wire = [("dense", np.full((1, 1), 10 + j)) for j in range(3)]
    tasks = {t.worker: t for t in make_tasks(code.M)}
    for w in range(code.num_workers):
        rows = code.worker_rows[w]
        A_w, B_w = procpool._worker_operands(A_wire, B_wire,
                                             [tasks[r] for r in rows], 3)
        cols = {int(c) for r in rows for c in code.M[r].indices}
        assert sorted(A_w) == sorted({c // 3 for c in cols})
        assert sorted(B_w) == sorted({c % 3 for c in cols})
        assert all(A_w[i] is A_wire[i] for i in A_w)


def test_worker_paused_right_after_sending_cannot_hang_the_master():
    """A worker SIGSTOPped the moment its chunk is in the pipe: the master
    still receives the whole chunk, since its payload is plain arrays (a
    torch tensor would travel as an fd fetched from the frozen sender)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    A, B = _data()
    code = schemes.sparse_code(M_SPLIT, N_SPLIT, N=4, seed=4)
    tasks = {t.worker: t for t in make_tasks(code.M)}
    A_wire, B_wire = procpool._wire_operands(split_blocks(A, M_SPLIT),
                                             split_blocks(B, N_SPLIT))
    rows = code.worker_rows[0]
    inbox_r, inbox_w = ctx.Pipe(duplex=False)
    recv_end, send_end = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=procpool._worker_main, daemon=True, args=(
        inbox_r, send_end, "cpu", time.time()))
    proc.start()
    send_end.close()
    inbox_r.close()
    got = {}
    try:
        inbox_w.send(("job", 0, {r: tasks[r].chunks(2) for r in rows}, N_SPLIT, 2, 0, 0.0,
                      3600.0,  # no heartbeat in the test's window
                      *procpool._worker_operands(A_wire, B_wire, [tasks[r] for r in rows],
                                                 N_SPLIT)))
        assert recv_end.poll(120), "the worker never said hello"
        assert recv_end.recv()[0] == "hello"
        inbox_w.send(("go",))
        assert recv_end.poll(120), "the worker sent no chunk"
        os.kill(proc.pid, signal.SIGSTOP)  # the chunk is in the pipe, or on its way

        def receive():
            got["msg"] = recv_end.recv()

        reader = threading.Thread(target=receive, daemon=True)
        reader.start()
        reader.join(timeout=30.0)
        assert not reader.is_alive(), "receiving the chunk hung on the frozen worker"
    finally:
        os.kill(proc.pid, signal.SIGCONT)
        proc.terminate()
        proc.join(timeout=10.0)
        inbox_w.close()
        recv_end.close()
    assert not proc.is_alive()
    tag, w, c, payload = got["msg"]
    assert (tag, w, c) == ("chunk", 0, 0) and payload
    for r, wire in payload.items():
        assert wire[0] == "csr" and all(isinstance(a, np.ndarray) for a in wire[1:4])
        blk = procpool.from_wire(wire, torch.device("cpu"))
        # the coded combination of chunk 0 of worker 0's row, made here
        ch = code.chunked(2)
        want = px._chunk_result(ch, r, [
            (torch.from_numpy((A.T @ B).toarray()[i * 8:(i + 1) * 8, j * 10:(j + 1) * 10]))
            for i in range(M_SPLIT) for j in range(N_SPLIT)])
        np.testing.assert_allclose(_dense(blk), _dense(want), rtol=0, atol=TOL)


def test_worker_that_cannot_open_the_device_ends_the_job():
    """No fallback: a worker told to compute on a CUDA device it cannot
    open reports the error, and the job ends with it, naming the worker."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the workers would open it")
    code = schemes.uncoded(1, 1)
    A, B = _data()
    pool = procpool.ProcPool(code, 1, split_blocks(A, 1), split_blocks(B, 1), 1,
                             device="cpu")
    pool.device = torch.device("cuda", 0)  # what a master on a card would send
    try:
        with pytest.raises(RuntimeError, match="worker process 0 failed"):
            pool.start(timeout=120.0)
    finally:
        pool.shutdown()
    assert all(not st.proc.is_alive() for st in pool._workers.values())


# ------------------------------ the mux pool --------------------------------

MUX_WORKERS = 8


@pytest.mark.parametrize("kind", ["ProcPool", "MuxProcPool"])
def test_master_opens_its_device_before_the_job_starts(kind, monkeypatch):
    """The master moves each arriving chunk to its device.  Opened only
    then, a card's device (its CUDA context: over a second on an H100)
    holds the first arrivals back until every worker's stream has come in,
    so the job decodes from whichever pipe is drained first -- before a
    fault's trigger is read -- and the context counts as compute.  Both
    pools open the master's device once, after their workers' hellos and
    before ``go``."""
    order = []
    warm, put = procpool._warm_device, procpool._Outbox.put
    monkeypatch.setattr(procpool, "_warm_device",
                        lambda dev: (order.append(("warm", dev)), warm(dev))[1])
    monkeypatch.setattr(procpool._Outbox, "put",
                        lambda self, msg: (order.append((msg[0], None)), put(self, msg))[1])
    if kind == "ProcPool":
        A, B = _data()
        pool = procpool.ProcPool(schemes.uncoded(M_SPLIT, N_SPLIT), 1,
                                 split_blocks(A, M_SPLIT), split_blocks(B, N_SPLIT),
                                 N_SPLIT, device="cpu")
        try:
            pool.start(60.0)
        finally:
            pool.shutdown()
        kinds = [k for k, _ in order]
        assert "go" in kinds and kinds.index("warm") < kinds.index("go")
    else:
        pool = MuxProcPool(2, device="cpu")
        try:
            pool.start()
        finally:
            pool.close()
    assert [dev for k, dev in order if k == "warm"] == [torch.device("cpu")]


@pytest.fixture(scope="module")
def proc_mux():
    """One pool of worker processes for the module's mux tests; worker 1 is
    killed when its first chunk arrives."""
    pool = MuxProcPool(MUX_WORKERS, plan=[kill(1, after_chunk=0)],
                       straggler_sleep={w: 0.8 for w in range(MUX_WORKERS)},
                       timeout=60.0, device="cpu")
    with px.JobMux(MUX_WORKERS, source=pool, device="cpu") as mux:
        procs = list(pool._procs.values())
        yield pool, mux
    assert len(procs) == MUX_WORKERS and all(not p.is_alive() for p in procs)


def _mux_job(code, q, tag, seed=0):
    A, B = _data(seed)
    return px.MuxJob(code=code, A_blocks=split_blocks(A, M_SPLIT),
                     B_blocks=split_blocks(B, N_SPLIT), n=N_SPLIT,
                     num_chunks=q, tag=tag), A, B


def test_mux_proc_pool_coded_jobs_decode_uncoded_fails_alone(proc_mux):
    pool, mux = proc_mux
    jobs = [_mux_job(schemes.sparse_code(M_SPLIT, N_SPLIT, N=8, seed=4), 2, "coded a"),
            _mux_job(schemes.sparse_code(M_SPLIT, N_SPLIT, N=8, seed=4), 1, "coded b", 1),
            _mux_job(schemes.uncoded(M_SPLIT, N_SPLIT), 2, "uncoded", 2)]
    results = mux.run([j for j, _, _ in jobs])
    assert [r.tag for r in results] == ["coded a", "coded b", "uncoded"]
    for res, (_, A, B) in zip(results[:2], jobs[:2]):
        assert res.ok, res.error
        _assert_product(res.blocks, A, B)
    assert not results[2].ok and results[2].blocks is None
    assert "worker process(es) [1] crashed" in results[2].error
    crash = [e for e in pool.ledger.entries if e["kind"] == "crash_detected"]
    assert [(e["worker"], e["exitcode"]) for e in crash] == [(1, -signal.SIGKILL)]
    assert sorted(pool.startup) == list(range(MUX_WORKERS))
    assert all(h["entry_s"] >= 0 and h["device_s"] >= 0 for h in pool.startup.values())


def test_mux_proc_pool_later_batch_skips_the_dead_worker(proc_mux):
    pool, mux = proc_mux
    dead_before = 1 in pool._crashed
    job, A, B = _mux_job(schemes.sparse_code(M_SPLIT, N_SPLIT, N=8, seed=4), 2,
                         "coded c", 3)
    (res,) = mux.run([job])
    assert res.ok, res.error
    _assert_product(res.blocks, A, B)
    if dead_before:
        assert res.report.worker_progress[1] == 0


def test_jobmux_source_object_device_and_kind_are_checked():
    class Source:
        device = torch.device("cuda", 0)

        def submit(self, chunkeds, jobs):
            raise AssertionError("not reached")

        def job_done(self, jid):
            pass

    with pytest.raises(ValueError, match=r"JobMux on cpu got a source on cuda:0"):
        px.JobMux(4, source=Source(), device="cpu")
    with pytest.raises(ValueError) as got:
        px.JobMux(4, source="procs", device="cpu")
    from repro.runtime import executor as jx

    with pytest.raises(ValueError) as want:
        jx.JobMux(4, source="procs")
    assert str(got.value) == str(want.value)


_NO_PROCESS_LEFT = """
import sys
import numpy as np
import scipy.sparse as sp
from repro_torch.core import schemes
from repro_torch.core.encoder import split_blocks
from repro_torch.runtime import procpool
from repro_torch.runtime.chaos import kill


def job():
    A = sp.random(40, 16, density=0.3, format="csc",
                  random_state=np.random.RandomState(0))
    B = sp.random(40, 20, density=0.3, format="csc",
                  random_state=np.random.RandomState(1))
    rep = procpool.run_proc_job(
        schemes.uncoded(2, 2), split_blocks(A, 2), split_blocks(B, 2), 2,
        num_chunks=2, plan=[kill(1, after_chunk=0)], respawn=True,
        device="cpu", timeout=60.0)
    assert rep.blocks is not None and len(rep.blocks) == 4


def children():
    import os
    out = []
    for p in filter(str.isdigit, os.listdir("/proc")):
        try:
            state, ppid = open(f"/proc/{p}/stat").read().rsplit(")", 1)[1].split()[:2]
            argv = open(f"/proc/{p}/cmdline").read().replace(chr(0), " ")
        except (OSError, ValueError):
            continue
        if ppid == str(os.getpid()) and state != "Z":
            out.append(argv)
    return out


if __name__ == "__main__":
    job()
    kids = children()
    assert any("forkserver" in c for c in kids), kids
    procpool.stop_fork_server()
    assert children() == [], children()
    job()  # the next pool starts them again; the exit stops them
"""


def test_program_that_ran_pools_leaves_no_process_behind(tmp_path):
    """The fork server and the resource tracker end with the program, and
    ``stop_fork_server`` ends them sooner: no process of the program's
    session (read from /proc) outlives it."""
    import pathlib
    import subprocess
    import sys

    script = tmp_path / "pools.py"
    script.write_text(_NO_PROCESS_LEFT)
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": str(src)}
    proc = subprocess.Popen([sys.executable, str(script)], env=env,
                            start_new_session=True, stderr=subprocess.PIPE)
    _, err = proc.communicate(timeout=120)
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            stat = pathlib.Path(f"/proc/{pid}/stat").read_text()
        except OSError:  # ended while being read
            continue
        if stat.rsplit(")", 1)[1].split()[3] == str(proc.pid):  # its session
            left.append(pid)
    assert proc.returncode == 0, err.decode()[-2000:]
    assert left == []


# ----------------------------- kept processes -------------------------------

#: the jobs one ``WorkerProcesses`` serves in turn, in chip_smoke's order:
#: a clean run, each fault class, a respawn and a kill at spawn (uncoded)
KEPT_JOBS = ("no fault", *MATRIX, "respawn", "kill at spawn")
#: the workers whose hello came from a fresh process (one that opened the
#: device for that job), job by job: every worker at first; then those
#: whose process the previous job's fault ended, and the respawned one
KEPT_FRESH = {"no fault": list(range(8)), "kill": [], "pause_past_deadline": [1],
              "slow10x": [], "drop_result": [], "respawn": [1]}


@pytest.fixture(scope="module")
def kept():
    """Every job of KEPT_JOBS over one ``WorkerProcesses`` on the CPU, in
    turn: each job's (report, A, B) or its ``DecodingError``; and the
    processes kept at the end, once they are closed."""
    coded = schemes.sparse_code(M_SPLIT, N_SPLIT, N=8, seed=4)
    uncoded = schemes.uncoded(M_SPLIT, N_SPLIT)
    out = {}
    with procpool.WorkerProcesses("cpu") as procs:
        for name in KEPT_JOBS:
            if name in MATRIX:
                fault = MATRIX[name]()
                args, kw = (coded, [fault]), {"faulted": fault.worker}
            elif name == "no fault":
                args, kw = (coded, None), {}
            else:
                args, kw = (uncoded, [kill(1)]), {"sleep": 0.4, "respawn": name == "respawn"}
            try:
                out[name] = _run(*args, processes=procs, **kw)
            except DecodingError as exc:
                out[name] = exc
        left = [proc for proc, _, _ in procs._idle.values()]
    return out, left


@pytest.mark.parametrize("name", [n for n in KEPT_JOBS if n != "kill at spawn"])
def test_kept_processes_decode_each_job(name, kept):
    """Each job on the processes the jobs before it used: the exact
    product, its fault in the ledger, and hellos from reused processes but
    where a fault ended the previous one."""
    rep, A, B = kept[0][name]
    _assert_product(rep.blocks, A, B)
    kinds = [e["kind"] for e in rep.fault_ledger]
    if name in MATRIX:
        fault = MATRIX[name]()
        assert any(e["kind"] == fault.kind and e["worker"] == fault.worker
                   for e in rep.fault_ledger), rep.fault_ledger
    elif name == "respawn":
        assert kinds == ["kill", "crash_detected", "respawn"]
        assert rep.fault_ledger[1]["exitcode"] == -signal.SIGKILL
    else:
        assert kinds == []
    hello = rep.decode_stats["startup"]["hello"]
    assert sorted(h["worker"] for h in hello if "device_s" in h) == KEPT_FRESH[name]
    assert all(h["operands_s"] >= 0 for h in hello)


def test_kept_processes_kill_at_spawn_names_worker(kept):
    err = kept[0]["kill at spawn"]
    assert isinstance(err, DecodingError), err
    assert "worker process(es) [1] crashed" in str(err)


def test_kept_processes_end_with_close(kept):
    """Seven processes were kept to the end: the eight slots' but worker
    1's, which the last job killed at spawn.  ``close`` ended them."""
    _, left = kept
    assert len(left) == 7
    assert not any(proc.is_alive() for proc in left)


def test_kept_processes_refuse_another_device():
    with procpool.WorkerProcesses("cpu") as procs:
        procs.device = torch.device("cuda", 0)  # as a card's processes would be
        A, B = _data()
        with pytest.raises(ValueError, match="the processes run on"):
            procpool.ProcPool(schemes.uncoded(1, 1), 1, split_blocks(A, 1),
                              split_blocks(B, 1), 1, device="cpu", processes=procs)
