"""``run_group_jobs``: several configurations of the worker group's coded
matmul in one launch of its ranks, on the CPU.

Three configurations (replicated with every worker alive, replicated with
worker 3 dead, out_sharded) in one launch of an 8-rank gloo group: each C
against the one-process ``CodedOp`` apply of the same configuration
(ONE_PROCESS_RTOL of max|C|), each report's ranks, samples and survivor
count as ``run_group_job`` gives them, and an undecodable mask refused
before any rank starts.

``chip_mesh.py``'s ``coded`` plan, one worker a card on four: a 4-worker
``sparse_code`` plan with m = 2, n = 1 (so the out_sharded
``reduce_scatter`` pads the 2 blocks to 4, one a rank, two of them zeros)
in both layouts, all alive and with workers 1 and 2 dead (the mask the
reference's ``_kill_masks`` draws for it), in one launch of a 4-rank gloo
group, against the JAX package's ``CodedOp.apply`` of the same plan and
mask (one subprocess, 4 host devices, under ``jax.jit``; its replicated C,
since its own out_sharded fails on this jax) within RTOL; each rank's
shard and its collective's bytes.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.coded import CodedMatmulConfig, from_plan  # noqa: E402
from repro_torch.core.coded_matmul import make_plan  # noqa: E402
from repro_torch.core.decoder import DecodingError  # noqa: E402
from repro_torch.sparse import dense_to_block_ell  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKERS, S, BS, M, N = 8, 64, 8, 2, 3
ONE_PROCESS_RTOL = 1e-6
RTOL = 1e-5
LAUNCH_TIMEOUT_S = 120.0
CARD_WORKERS, CARD_M, CARD_N = 4, 2, 1      # chip_mesh.py's coded part
CARD_MASKS = {"alive": None, "dead1,2": [True, False, False, True]}

_JAX_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d"
import jax
import numpy as np
from repro.coded import CodedMatmulConfig, plan
from repro.sparse import dense_to_block_ell

m, n, workers, masks = json.loads(sys.argv[2])
inputs = np.load(sys.argv[1])
A, B = inputs["A"], inputs["B"]
op = plan(CodedMatmulConfig(scheme="sparse_code", backend="block_sparse"), m, n, workers,
          seed=0).bind()
out = {f: np.asarray(getattr(op.base_plan, f)) for f in ("cols", "weights", "decode",
                                                         "max_degree")}
ell = dense_to_block_ell(A, 8)
for key, mask in masks.items():
    o = op if mask is None else op.with_survivors(np.asarray(mask, dtype=bool))
    out["C/" + key] = np.asarray(jax.jit(lambda a, b, o=o: o.apply(a, b, a_sparse=ell))(A, B))
np.savez(sys.argv[3], **out)
""" % CARD_WORKERS


def _operands(m: int = M, n: int = N):
    rng = np.random.default_rng(23)
    r, t = 8 * m, 12 * n
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


@pytest.fixture(scope="module")
def card_reference(tmp_path_factory) -> dict:
    tmp = tmp_path_factory.mktemp("group_jobs")
    A, B = _operands(CARD_M, CARD_N)
    np.savez(tmp / "inputs.npz", A=A, B=B)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    spec = json.dumps([CARD_M, CARD_N, CARD_WORKERS, CARD_MASKS])
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(tmp / "inputs.npz"), spec,
                           str(tmp / "out.npz")], env=env, capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def test_one_worker_a_card_plan_matches_the_reference(card_reference):
    """chip_mesh.py's ``coded`` configurations on 4 gloo ranks against the
    reference's apply: both layouts, all alive and two workers dead."""
    from repro_torch.coded.convert import plan_from_numpy
    from repro_torch.runtime import run_group_jobs

    A, B = _operands(CARD_M, CARD_N)
    plan = plan_from_numpy({**card_reference, "m": CARD_M, "n": CARD_N,
                            "num_workers": CARD_WORKERS})
    keys = [(sharded, key) for sharded in (False, True) for key in CARD_MASKS]
    reports = run_group_jobs(
        A, B, plan, backend="gloo", device="cpu", repeats=1,
        configs=[(sharded, None if CARD_MASKS[key] is None else np.asarray(CARD_MASKS[key]))
                 for sharded, key in keys],
        a_sparse=dense_to_block_ell(A, BS), timeout=LAUNCH_TIMEOUT_S)
    br, bt = A.shape[1] // CARD_M, B.shape[1] // CARD_N
    for (sharded, key), rep in zip(keys, reports, strict=True):
        want = card_reference[f"C/{key}"]
        (C,) = rep.blocks
        np.testing.assert_allclose(C.numpy(), want, rtol=RTOL,
                                   atol=RTOL * float(np.abs(want).max()), err_msg=key)
        block = br * bt * 4
        for rank in rep.decode_stats["ranks"]:
            moved = {k: v for k, v in rank["collectives"]["bytes"].items() if v}
            if sharded:  # mn_pad / N = 1 block a rank
                assert rank["shard_shape"] == [1, br, bt], rank["shard_shape"]
                assert moved == {"reduce-scatter": block}, moved
            else:
                assert rank["shard_shape"] == [A.shape[1], B.shape[1]]
                assert moved == {"all-reduce": CARD_M * CARD_N * block}, moved
