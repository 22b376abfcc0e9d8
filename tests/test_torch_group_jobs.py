"""``run_group_jobs``: several configurations of the worker group's coded
matmul in one launch of its ranks, on the CPU.

Three configurations (replicated with every worker alive, replicated with
worker 3 dead, out_sharded) in one launch of an 8-rank gloo group: each C
against the one-process ``CodedOp`` apply of the same configuration
(ONE_PROCESS_RTOL of max|C|), each report's ranks, samples and survivor
count as ``run_group_job`` gives them, and an undecodable mask refused
before any rank starts.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.coded import CodedMatmulConfig, from_plan  # noqa: E402
from repro_torch.core.coded_matmul import make_plan  # noqa: E402
from repro_torch.core.decoder import DecodingError  # noqa: E402
from repro_torch.sparse import dense_to_block_ell  # noqa: E402

WORKERS, S, BS, M, N = 8, 64, 8, 2, 3
ONE_PROCESS_RTOL = 1e-6
LAUNCH_TIMEOUT_S = 120.0


def _operands():
    rng = np.random.default_rng(23)
    r, t = 8 * M, 12 * N
    mask = rng.random((S // BS, r // BS)) < 0.3
    A = (rng.standard_normal((S, r)) * np.kron(mask, np.ones((BS, BS)))).astype(np.float32)
    return A, rng.standard_normal((S, t)).astype(np.float32)


def _dead(worker: int) -> np.ndarray:
    alive = np.ones(WORKERS, dtype=bool)
    alive[worker] = False
    return alive


def test_three_configurations_in_one_launch():
    from repro_torch.runtime import run_group_jobs

    A, B = _operands()
    plan = make_plan(M, N, WORKERS, seed=1)
    configs = [(False, None), (False, _dead(3)), (True, None)]
    reports = run_group_jobs(A, B, plan, backend="gloo", device="cpu", configs=configs,
                             repeats=2, a_sparse=dense_to_block_ell(A, BS),
                             timeout=LAUNCH_TIMEOUT_S)
    assert len(reports) == 3
    for (sharded, mask), rep in zip(configs, reports, strict=True):
        op = from_plan(CodedMatmulConfig(backend="block_sparse"), plan).bind("cpu")
        want = (op if mask is None else op.with_survivors(mask))(A, B)
        (C,) = rep.blocks
        assert C.shape == want.shape
        assert float((C - want).abs().max()) <= ONE_PROCESS_RTOL * float(want.abs().max())
        stats = rep.decode_stats
        assert stats["out_sharded"] == sharded and stats["group"] == WORKERS
        assert [r["rank"] for r in stats["ranks"]] == list(range(WORKERS))
        assert all(len(r["samples"]["apply_ms"]) == 2 for r in stats["ranks"])
        assert rep.workers_used == (WORKERS - 1 if mask is not None else WORKERS)
        assert rep.total_time == max(r["apply_ms"] for r in stats["ranks"]) / 1e3


def test_an_undecodable_mask_raises_before_a_rank_starts():
    from repro_torch.runtime import run_group_jobs

    A, B = _operands()
    plan = make_plan(M, N, WORKERS, seed=1)
    alive = np.zeros(WORKERS, dtype=bool)
    alive[0] = True
    with pytest.raises(DecodingError, match="cannot decode"):
        run_group_jobs(A, B, plan, backend="gloo", device="cpu",
                       configs=[(False, None), (False, alive)], timeout=LAUNCH_TIMEOUT_S)
