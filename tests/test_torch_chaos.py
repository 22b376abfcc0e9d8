"""The port's fault plans against the JAX package's, on the CPU.

* ``Fault`` / ``FaultPlan``: every malformed plan raises the reference's
  ``ValueError``, word for word;
* ``FaultRealization.chunk_completion_times`` (the simulator twin of a
  plan): the reference's timeline bit for bit, infinities included, over
  every fault class alone and together;
* ``run_coded_job`` under a ``FaultRealization``: the reference's report
  (simulated time, workers, chunks, decode stats) bit for bit, and the
  decoded blocks within 1e-10 (float64, dense and CSR).

Host code only: no worker process is started here.
"""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from repro.core import schemes as js  # noqa: E402
from repro.core.encoder import compute_block_products, split_blocks  # noqa: E402
from repro.runtime import chaos as jc  # noqa: E402
from repro.runtime import executor as jx  # noqa: E402

from repro_torch.core import blocks as pb  # noqa: E402
from repro_torch.core import schemes as ps  # noqa: E402
from repro_torch.runtime import chaos as pc  # noqa: E402
from repro_torch.runtime import executor as px  # noqa: E402

TOL = 1e-10

# each malformed plan, as a call on a chaos module
BAD_PLANS = {
    "unknown kind": lambda c: c.Fault(kind="meteor", worker=0),
    "negative worker": lambda c: c.kill(-1),
    "slow factor": lambda c: c.slow(0, factor=1.0),
    "drop without chunk": lambda c: c.Fault(kind="drop_result", worker=0),
    "worker outside the job": lambda c: c.FaultPlan.coerce(
        [c.kill(5), c.drop_result(0, chunk=3)]).validate(num_workers=4, num_chunks=4),
    "chunk outside the job": lambda c: c.FaultPlan.coerce(
        [c.kill(5), c.drop_result(0, chunk=3)]).validate(num_workers=8, num_chunks=2),
    "kill trigger outside the job": lambda c: c.FaultPlan.coerce(
        c.kill(1, after_chunk=4)).validate(num_workers=8, num_chunks=4),
}

# fault plans for the timeline, as a list of faults made by a chaos module
PLANS = {
    "slow": lambda c: [c.slow(0, factor=10.0)],
    "kill after chunk 0": lambda c: [c.kill(1, after_chunk=0)],
    "kill at spawn": lambda c: [c.kill(2)],
    "pause with duration": lambda c: [c.pause(3, after_chunk=0, duration=5.0)],
    "pause forever": lambda c: [c.pause(3, after_chunk=1)],
    "drop_result": lambda c: [c.drop_result(0, chunk=1)],
    "all at once": lambda c: [c.slow(0, factor=3.5), c.kill(1, after_chunk=2),
                              c.pause(2, duration=0.25), c.pause(2, after_chunk=1,
                                                                 duration=1.5),
                              c.drop_result(4, chunk=2), c.kill(4, after_chunk=0)],
}


@pytest.mark.parametrize("case", sorted(BAD_PLANS))
def test_fault_plan_errors_match_reference(case):
    with pytest.raises(ValueError) as want:
        BAD_PLANS[case](jc)
    with pytest.raises(ValueError) as got:
        BAD_PLANS[case](pc)
    assert str(got.value) == str(want.value)


def test_fault_plan_coercion_and_geometry():
    plan = pc.FaultPlan.coerce([pc.kill(5), pc.drop_result(0, chunk=3)])
    plan.validate(num_workers=8, num_chunks=4)  # geometry fits: no raise
    assert plan.workers == [0, 5]
    assert pc.FaultPlan.coerce(None).faults == ()
    assert pc.FaultPlan.coerce(pc.kill(0)).faults[0].kind == "kill"
    assert pc.FaultPlan.coerce(plan) is plan
    assert pc.FAULT_KINDS == jc.FAULT_KINDS and pc.SLOW_SLICE == jc.SLOW_SLICE


def test_fault_ledger_summary_matches_reference():
    ledgers = []
    for c in (jc, pc):
        led = c.FaultLedger()
        led.record("kill", 1, after_chunk=0, pid=11)
        led.record("crash_detected", 1, exitcode=-9, next_chunk=1)
        led.record("drop_result", 3, chunk=2)
        led.entries[1].update(equations_recovered=1, equations_lost=2)
        led.entries[2].update(equations_recovered=0, equations_lost=1)
        ledgers.append(led)
    assert ledgers[1].summary() == ledgers[0].summary()
    assert ledgers[1].workers() == ledgers[0].workers() == [1, 3]


@pytest.mark.parametrize("q", [1, 3, 4])
@pytest.mark.parametrize("case", sorted(PLANS))
def test_fault_realization_timeline_bit_for_bit(case, q):
    rng = np.random.default_rng(7)
    work = rng.random((6, q)) + 0.5
    want = jc.FaultRealization(plan=jc.FaultPlan.coerce(PLANS[case](jc)))
    got = pc.FaultRealization(plan=pc.FaultPlan.coerce(PLANS[case](pc)))
    t_want = want.chunk_completion_times(work, np.random.default_rng(0))
    t_got = got.chunk_completion_times(work, np.random.default_rng(0))
    assert t_got.dtype == t_want.dtype and np.array_equal(t_got, t_want)
    nominal = work.sum(axis=1)
    assert np.array_equal(got.completion_times(nominal, None),
                          want.completion_times(nominal, None))
    for c in (jc, pc):  # a fault beyond the realization's workers
        bad = c.FaultRealization(plan=c.FaultPlan.coerce(c.kill(9)))
        with pytest.raises(ValueError, match="targets worker 9, realization has 6"):
            bad.chunk_completion_times(work, None)


def test_fault_realization_timeline_edits():
    """The plan rewrites the (N, q) chunk timeline: stretch, cut, shift."""
    work = np.ones((4, 3))
    rng = np.random.default_rng(0)

    def times(*faults):
        return pc.FaultRealization(plan=pc.FaultPlan.coerce(list(faults))) \
            .chunk_completion_times(work, rng)

    t = times(pc.slow(0, factor=10.0))
    np.testing.assert_allclose(t[0], [10.0, 20.0, 30.0])
    np.testing.assert_allclose(t[1], [1.0, 2.0, 3.0])
    t = times(pc.kill(1, after_chunk=0))
    assert t[1, 0] == 1.0 and np.isinf(t[1, 1:]).all()
    assert np.isinf(times(pc.kill(2))[2]).all()
    np.testing.assert_allclose(times(pc.pause(3, after_chunk=0, duration=5.0))[3],
                               [1.0, 7.0, 8.0])
    t = times(pc.pause(3, after_chunk=1))
    assert t[3, 0] == 1.0 and t[3, 1] == 2.0 and np.isinf(t[3, 2])
    t = times(pc.drop_result(0, chunk=1))
    assert t[0, 0] == 1.0 and np.isinf(t[0, 1:]).all()
    with pytest.raises(ValueError, match=r"work must be \(N, q\)"):
        pc.FaultRealization().chunk_completion_times(np.ones(3), rng)


def _dense(b) -> np.ndarray:
    if isinstance(b, torch.Tensor):
        return (b.to_dense() if pb.is_csr(b) else b).numpy()
    return b.toarray() if sp.issparse(b) else np.asarray(b)


def _true_blocks(m, n, sparse, seed=1):
    if sparse:
        A = sp.random(40, 6 * m, density=0.3, format="csc",
                      random_state=np.random.RandomState(seed))
        B = sp.random(40, 7 * n, density=0.3, format="csc",
                      random_state=np.random.RandomState(seed + 1))
        prods = compute_block_products(split_blocks(A, m), split_blocks(B, n))
        return [prods[i][j] for i in range(m) for j in range(n)]
    rng = np.random.default_rng(seed)
    return [rng.random((6, 7)) for _ in range(m * n)]


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("case", ["kill after chunk 0", "drop_result", "all at once"])
def test_run_coded_job_under_fault_realization_matches_reference(case, sparse):
    """The simulator routes around the plan's lost chunks exactly as the
    reference's does: the same arrivals, the same decode."""
    m, n, N, q = 2, 2, 8, 4
    blocks = _true_blocks(m, n, sparse)
    want = jx.run_coded_job(js.sparse_code(m, n, N, seed=4), blocks,
                            jc.FaultRealization(plan=jc.FaultPlan.coerce(PLANS[case](jc))),
                            rng=np.random.default_rng(1), num_chunks=q, keep_blocks=True)
    got = px.run_coded_job(ps.sparse_code(m, n, N, seed=4), blocks,
                           pc.FaultRealization(plan=pc.FaultPlan.coerce(PLANS[case](pc))),
                           rng=np.random.default_rng(1), num_chunks=q, keep_blocks=True,
                           device="cpu")
    for f in ("scheme", "workers_used", "num_workers", "sim_compute_time",
              "num_chunks", "chunks_used", "decode_stats", "fault_ledger"):
        assert getattr(got, f) == getattr(want, f), f
    assert np.isfinite(got.sim_compute_time)
    for g, w, truth in zip(got.blocks, want.blocks, blocks):
        assert g.layout == (torch.sparse_csr if sparse else torch.strided)
        np.testing.assert_allclose(_dense(g), _dense(w), rtol=0, atol=TOL)
        np.testing.assert_allclose(_dense(g), _dense(truth), rtol=0, atol=1e-8)
