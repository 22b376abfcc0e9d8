"""The port's straggler runtime against the JAX package's, on the CPU.

* ``run_coded_job`` under every straggler model, atomic and chunked: the
  reference's ``sim_compute_time``, ``workers_used``, ``chunks_used`` and
  ``decode_stats``, bit for bit (the same seeded timeline, the same event
  loop), and the decoded blocks within 1e-10 of the reference's (float64,
  dense and sparse CSR; a CSR block stays CSR);
* ``JobMux(source="sim")``: every ``MuxResult`` as the reference's, the
  undecodable job failing with the same reason;
* ``run_live_job`` and ``JobMux(source="live")``: outcomes only, never
  timings -- the decoded blocks, a hung worker named in a
  ``DecodingError``, a crashed worker failing fast, and no worker thread
  outliving its job (sleeps stay under 0.5 s);
* ``run_device_job(device="cpu")``: C bit for bit the port's
  ``CodedOp.apply`` (which ``test_torch_coded_op.py`` holds to the JAX op)
  for an (N,) and an (N, q) mask, and the reference's ``decode_stats``
  keys; ``coded_matmul`` warns and gives the same C, bit for bit.
"""

from __future__ import annotations

import re
import threading

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from repro.core import schemes as js  # noqa: E402
from repro.core.encoder import compute_block_products, split_blocks  # noqa: E402
from repro.runtime import executor as jx  # noqa: E402
from repro.runtime import straggler as jst  # noqa: E402

from repro_torch.coded import CodedMatmulConfig, plan  # noqa: E402
from repro_torch.core import blocks as pb  # noqa: E402
from repro_torch.core import coded_matmul as pcm  # noqa: E402
from repro_torch.core import schemes as ps  # noqa: E402
from repro_torch.core.decoder import DecodingError  # noqa: E402
from repro_torch.runtime import executor as px  # noqa: E402
from repro_torch.runtime import straggler as pst  # noqa: E402
from repro_torch.sparse import dense_to_block_ell  # noqa: E402

TOL = 1e-10
MODELS = [
    ("NoStragglers", ()), ("SlowWorkers", (3, 10.0)),
    ("ExponentialStragglers", (0.5,)), ("ShiftedExponential", (1.0,)),
    ("SlowWorkerRates", (3, 8.0)), ("LogNormalRates", (0.5,)),
]


def _dense(b) -> np.ndarray:
    if isinstance(b, torch.Tensor):
        return (b.to_dense() if pb.is_csr(b) else b).numpy()
    return b.toarray() if sp.issparse(b) else np.asarray(b)


def _assert_blocks_close(got, want, layout):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.layout == layout and g.dtype == torch.float64
        np.testing.assert_allclose(_dense(g), _dense(w), rtol=0, atol=TOL)


def _sparse_operands(m, n, s=40, r=18, t=24, seed=0):
    A = sp.random(s, r, density=0.3, format="csc", random_state=np.random.RandomState(seed))
    B = sp.random(s, t, density=0.3, format="csc",
                  random_state=np.random.RandomState(seed + 1))
    return A, B, split_blocks(A, m), split_blocks(B, n)


def _true_blocks(m, n, sparse, seed=0):
    if sparse:
        _, _, Ab, Bb = _sparse_operands(m, n, seed=seed)
        prods = compute_block_products(Ab, Bb)
        return [prods[i][j] for i in range(m) for j in range(n)]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((6, 7)) for _ in range(m * n)]


@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("model,args", MODELS)
def test_run_coded_job_matches_reference(model, args, q):
    m, n, N = 3, 3, 22
    for sparse, code_name in ((False, "sparse_code"), (True, "sparse_code"),
                              (False, "lt_code")):
        blocks = _true_blocks(m, n, sparse)
        cj = getattr(js, code_name)(m, n, N, seed=1)
        cp = getattr(ps, code_name)(m, n, N, seed=1)
        want = jx.run_coded_job(cj, blocks, getattr(jst, model)(*args),
                                rng=np.random.default_rng(11), unit_block_time=0.1,
                                keep_blocks=True, num_chunks=q)
        got = px.run_coded_job(cp, blocks, getattr(pst, model)(*args),
                               rng=np.random.default_rng(11), unit_block_time=0.1,
                               keep_blocks=True, num_chunks=q, device="cpu")
        for f in ("scheme", "workers_used", "num_workers", "sim_compute_time",
                  "num_chunks", "chunks_used", "decode_stats", "fault_ledger"):
            assert getattr(got, f) == getattr(want, f), f
        _assert_blocks_close(got.blocks, want.blocks,
                             torch.sparse_csr if sparse else torch.strided)
        assert got.decode_wall_time > 0
        assert got.total_time == got.sim_compute_time + got.decode_wall_time


def test_run_coded_job_keeps_no_blocks_unless_asked():
    blocks = _true_blocks(2, 2, False)
    rep = px.run_coded_job(ps.sparse_code(2, 2, 10, seed=2), blocks,
                           pst.SlowWorkers(2, 5.0), device="cpu")
    assert rep.blocks is None and rep.chunks_used == rep.decode_stats["arrivals_consumed"]


@pytest.mark.parametrize("entry", ["coded", "live", "mux_sim", "mux_live"])
def test_report_names_the_chunks_taken_from_each_worker(entry):
    """``worker_progress`` counts the chunks consumed from each worker: it
    sums to ``chunks_used`` and its nonzero entries are ``workers_used``."""
    m = n = 2
    q = 3
    A, B, Ab, Bb = _sparse_operands(m, n)
    code = ps.sparse_code(m, n, 10, seed=4)
    if entry == "coded":
        rep = px.run_coded_job(code, _true_blocks(m, n, True), pst.SlowWorkers(2, 5.0),
                               num_chunks=q, device="cpu")
    elif entry == "live":
        rep = px.run_live_job(code, Ab, Bb, n, straggler_sleep={0: 0.3},
                              num_chunks=q, device="cpu")
    else:
        source = entry.removeprefix("mux_")
        with px.JobMux(10, source=source, device="cpu") as mux:
            (res,) = mux.run([px.MuxJob(code=code, A_blocks=Ab, B_blocks=Bb, n=n,
                                        num_chunks=q)])
        rep = res.report
    progress = np.asarray(rep.worker_progress)
    assert progress.shape == (10,) and progress.max() <= q
    assert int(progress.sum()) == rep.chunks_used
    assert int(np.count_nonzero(progress)) == rep.workers_used


def _mux_jobs(mod, schemes_mod, sparse):
    jobs = []
    for k, (code, q) in enumerate([(schemes_mod.sparse_code(2, 2, 10, seed=3), 1),
                                   (schemes_mod.sparse_code(2, 2, 8, seed=4), 3),
                                   (schemes_mod.uncoded(2, 2), 1),
                                   (schemes_mod.lt_code(2, 2, 12, seed=5), 2)]):
        if sparse:
            _, _, Ab, Bb = _sparse_operands(2, 2, seed=k)
        else:
            rng = np.random.default_rng(k)
            Ab = split_blocks(rng.standard_normal((12, 8)), 2)
            Bb = split_blocks(rng.standard_normal((12, 10)), 2)
        jobs.append(mod.MuxJob(code=code, A_blocks=Ab, B_blocks=Bb, n=2,
                               num_chunks=q, tag=f"job{k}"))
    return jobs


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("dead", [(), (1,)])
def test_jobmux_sim_matches_reference(dead, sparse):
    kw = dict(source="sim", straggler=None, unit_block_time=0.5, dead_workers=dead)
    with jx.JobMux(12, rng=np.random.default_rng(2), **kw) as mj, \
            px.JobMux(12, rng=np.random.default_rng(2), device="cpu", **kw) as mp:
        for _ in range(2):  # two batches over the same persistent pool
            want = mj.run(_mux_jobs(jx, js, sparse))
            got = mp.run(_mux_jobs(px, ps, sparse))
            assert len(got) == len(want) == 4
            for g, w in zip(got, want):
                assert (g.tag, g.ok, g.error) == (w.tag, w.ok, w.error)
                if not w.ok:
                    assert g.blocks is None
                    continue
                gr, wr = g.report, w.report
                for f in ("scheme", "workers_used", "num_workers", "sim_compute_time",
                          "num_chunks", "chunks_used"):
                    assert getattr(gr, f) == getattr(wr, f), f
                strip = lambda d: {k: v for k, v in d.items() if k != "pack_cache"}
                assert strip(gr.decode_stats) == strip(wr.decode_stats)
                assert set(gr.decode_stats) == set(wr.decode_stats)
                _assert_blocks_close(g.blocks, w.blocks,
                                     torch.sparse_csr if sparse else torch.strided)
    # the dead worker leaves the uncoded job undecodable, in both
    assert [w.ok for w in want] == [True, True, not dead, True]


def _live_threads(prefix: str) -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.name.startswith(prefix) and t.is_alive()]


def _check_product(rep, A, B, m, n):
    C = (A.T @ B).toarray()
    br, bt = C.shape[0] // m, C.shape[1] // n
    for i in range(m):
        for j in range(n):
            blk = rep.blocks[i * n + j]
            assert blk.layout == torch.sparse_csr
            np.testing.assert_allclose(_dense(blk), C[i * br:(i + 1) * br, j * bt:(j + 1) * bt],
                                       rtol=0, atol=1e-8)


@pytest.mark.parametrize("q", [1, 3])
def test_live_job_decodes_without_the_sleepers_and_joins_its_threads(q):
    m = n = 2
    A, B, Ab, Bb = _sparse_operands(m, n)
    code = ps.sparse_code(m, n, 10, seed=4)
    rep = px.run_live_job(code, Ab, Bb, n, straggler_sleep={0: 0.4, 1: 0.4},
                          num_chunks=q, device="cpu")
    _check_product(rep, A, B, m, n)
    assert rep.num_chunks == q and rep.chunks_used == rep.decode_stats["arrivals_consumed"]
    assert rep.decode_stats["tracker_rank"] == m * n
    assert _live_threads("live-worker-") == []


def test_live_job_hung_worker_raises_decoding_error_naming_it():
    m = n = 2
    _, _, Ab, Bb = _sparse_operands(m, n)
    with pytest.raises(DecodingError, match="never reported") as ei:
        px.run_live_job(ps.uncoded(m, n), Ab, Bb, n, straggler_sleep={2: 30.0},
                        timeout=0.5, device="cpu")
    never = re.search(r"workers \[([\d, ]*)\] never reported", str(ei.value))
    assert 2 in [int(w) for w in never.group(1).split(",")]
    assert _live_threads("live-worker-") == []


def test_live_job_crashed_worker_fails_fast(monkeypatch):
    m = n = 2
    _, _, Ab, Bb = _sparse_operands(m, n)
    real = px.encode_blocks

    def dying(chunk, A_blocks, B_blocks, n_):
        if chunk.worker == 2:
            raise RuntimeError("simulated worker crash")
        return real(chunk, A_blocks, B_blocks, n_)

    monkeypatch.setattr(px, "encode_blocks", dying)
    with pytest.raises(DecodingError, match=r"\[2\] exited before delivering") as ei:
        px.run_live_job(ps.uncoded(m, n), Ab, Bb, n, timeout=30.0, device="cpu")
    assert "simulated worker crash" in str(ei.value)


def test_jobmux_live_batches_decode_and_stop_their_threads():
    m = n = 2
    A, B, Ab, Bb = _sparse_operands(m, n)
    jobs = [px.MuxJob(code=ps.sparse_code(m, n, 10, seed=s), A_blocks=Ab, B_blocks=Bb,
                      n=n, num_chunks=q, tag=s) for s, q in ((0, 1), (1, 2), (2, 3))]
    with px.JobMux(10, source="live", straggler_sleep={3: 0.4}, device="cpu") as mux:
        for _ in range(2):
            results = mux.run(jobs)
            assert [r.tag for r in results] == [0, 1, 2] and all(r.ok for r in results)
            for r in results:
                _check_product(r.report, A, B, m, n)
                assert r.report.decode_stats["concurrent_jobs"] == 3
    assert _live_threads("mux-worker-") == []
    with px.JobMux(4, source="live", dead_workers=[2], timeout=5.0, device="cpu") as mux:
        (res,) = mux.run([px.MuxJob(code=ps.uncoded(m, n), A_blocks=Ab, B_blocks=Bb, n=n)])
    assert not res.ok and "[2] dead for the whole batch" in res.error
    assert _live_threads("mux-worker-") == []


def _device_operands(seed=0, s=32, r=16, t=24, bs=8):
    rng = np.random.default_rng(seed)
    mask = rng.random((s // bs, r // bs)) < 0.5
    A = (rng.standard_normal((s // bs, bs, r // bs, bs)).astype(np.float32)
         * mask[:, None, :, None]).reshape(s, r)
    B = rng.standard_normal((s, t)).astype(np.float32)
    return A, B, dense_to_block_ell(A, bs)


_CHUNK_MASK = np.ones((8, 2), dtype=bool)
_CHUNK_MASK[4, 1] = False


@pytest.mark.parametrize("survivors", [None, "dead", "chunks"])
@pytest.mark.parametrize("backend", ["dense_scan", "block_sparse"])
def test_run_device_job_and_coded_matmul_equal_coded_op(backend, survivors):
    A, B, ell = _device_operands()
    op = plan(CodedMatmulConfig(backend=backend), 2, 2, 8, seed=0).bind("cpu")
    if survivors == "dead":
        mask = np.ones(8, dtype=bool)
        mask[3] = False
    else:
        mask = _CHUNK_MASK if survivors == "chunks" else None
    ref_op = op.with_survivors(mask) if mask is not None else op
    kw = {"a_sparse": ell} if backend == "block_sparse" else {}
    want = ref_op(A, B, **kw)
    rep = px.run_device_job(A, B, op.base_plan, device="cpu", backend=backend,
                            survivors=mask, repeats=2, **kw)
    (C,) = rep.blocks
    assert torch.equal(C, want)
    assert rep.scheme == f"spmd_{backend}" and rep.decode_wall_time == 0.0
    assert rep.workers_used == (8 if survivors != "dead" else 7)
    assert rep.decode_stats["on_device_decode"] and rep.total_time > 0
    with pytest.warns(DeprecationWarning, match="deprecated"):
        C2 = pcm.coded_matmul(A, B, op.base_plan, device="cpu", survivors=mask,
                              backend=backend, **kw)
    assert torch.equal(C2, want)
    assert torch.allclose(pcm.uncoded_matmul_reference(A, B),
                          torch.from_numpy(A.T @ B), rtol=1e-5, atol=1e-4)


def test_run_device_job_report_keys_are_the_references():
    from repro.core.coded_matmul import make_plan as jax_make_plan
    from repro.runtime import run_device_job as jax_run_device_job

    rng = np.random.default_rng(6)
    A = rng.standard_normal((24, 16)).astype(np.float32)
    B = rng.standard_normal((24, 8)).astype(np.float32)
    want = jax_run_device_job(A, B, jax_make_plan(1, 1, num_workers=1, max_degree=1),
                              repeats=1)
    got = px.run_device_job(A, B, pcm.make_plan(1, 1, num_workers=1, max_degree=1),
                            device="cpu", repeats=1)
    assert set(got.decode_stats) == set(want.decode_stats)
    assert {k: v for k, v in got.decode_stats.items() if k != "pack_cache"} == \
        {k: v for k, v in want.decode_stats.items() if k != "pack_cache"}
    assert (got.scheme, got.workers_used, got.num_workers) == \
        (want.scheme, want.workers_used, want.num_workers)
    np.testing.assert_allclose(got.blocks[0].numpy(), np.asarray(want.blocks[0]),
                               rtol=1e-5, atol=1e-5)
