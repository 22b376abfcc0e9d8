"""The worker axis as a process group: the port's group path against the JAX package's mesh.

One subprocess (8 host devices) applies ``repro.coded.CodedOp`` under
``jax.jit`` to every case below, as ``test_torch_coded_op.py`` does, and
writes the results and the plans it used to an ``.npz``.  One gloo group
of 8 CPU ranks (``runtime.workergroup.spawn_group``, one launch for the
whole file) binds the port's ``CodedOp`` to its world group, fed those very
plans, and applies every case in both decode layouts: rank k runs worker k
and the ranks combine with an ``all_reduce`` or a padded
``reduce_scatter``; the sharded C is read back with ``gather_blocks``.

* Every case's C, in both layouts, against the JAX package's replicated C
  within RTOL (the reference's own ``out_sharded`` does not run on the jax
  here, ROADMAP section 3) and against the port's one-process apply within
  ONE_PROCESS_RTOL of max|C|: the same plan and tiles, the sum over the
  workers in gloo's order instead of a ``torch.stack(...).sum(0)``.
* Rank k's shard holds blocks ``[k mn_pad/N, (k+1) mn_pad/N)`` of the
  one-process blocks padded to ``mn_pad``, the reference's
  ``P(axis_name)`` layout; its pad blocks are exact zeros.
* The refusals: a group of the wrong size, nccl with fewer cards than
  ranks, a launch past its wall limit and a rank that fails (no process
  left behind either way); ``run_group_job`` on the CPU.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.coded import CodedMatmulConfig, from_plan  # noqa: E402
from repro_torch.coded.convert import plan_from_numpy  # noqa: E402
from repro_torch.core import coded_matmul as pcm  # noqa: E402
from repro_torch.runtime import pack_cache, workergroup  # noqa: E402
from repro_torch.sparse import dense_to_block_ell  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKERS, S, BS = 8, 64, 8
RTOL = 1e-5
ONE_PROCESS_RTOL = 1e-6
LAUNCH_TIMEOUT_S = 120.0

_CHUNKS = np.ones((WORKERS, 2), dtype=bool)
_CHUNKS[4, 1] = _CHUNKS[6, 1] = False       # two workers finished half their slots
_CHUNKS = _CHUNKS.tolist()


def _dead(*workers):
    mask = np.ones(WORKERS, dtype=bool)
    mask[list(workers)] = False
    return mask.tolist()


# (backend, compute_dtype, survivors mask) -- each in both layouts, at both (m, n)
_MATRIX = [
    ("dense_scan", "float32", None),
    ("dense_scan", "float32", _dead(3)),
    ("dense_scan", "float32", _dead(1, 5)),
    ("dense_scan", "float32", _CHUNKS),
    ("block_sparse", "float32", None),
    ("block_sparse", "float32", _dead(3)),
    ("block_sparse", "float32", _dead(1, 5)),
    ("block_sparse", "float32", _CHUNKS),
    ("block_sparse", "bfloat16", None),
    ("block_sparse", "bfloat16", _dead(3)),
    ("auto", "float32", None),
    ("auto", "float32", _dead(3)),
]
CASES = [dict(id=f"m{m}n{n}-{be}-{cd}-{i}", m=m, n=n, backend=be, compute_dtype=cd, mask=mask)
         for m, n in [(2, 2), (2, 3)]
         for i, (be, cd, mask) in enumerate(_MATRIX)]
IDS = [c["id"] for c in CASES]
LAYOUTS = ("replicated", "sharded")

_JAX_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
from repro.coded import CodedMatmulConfig, plan
from repro.sparse import dense_to_block_ell

inputs = np.load(sys.argv[1])
cases = json.loads(sys.argv[2])
out = {}
for c in cases:
    m, n = c["m"], c["n"]
    cfg = CodedMatmulConfig(scheme="sparse_code", backend=c["backend"],
                            compute_dtype=c["compute_dtype"])
    op = plan(cfg, m, n, 8, seed=0).bind()
    key = f"m{m}n{n}"
    p = op.base_plan
    for f in ("cols", "weights", "decode", "max_degree"):
        out[f"plan/{key}/{f}"] = np.asarray(getattr(p, f))
    if c["mask"] is not None:
        op = op.with_survivors(np.asarray(c["mask"], dtype=bool))
    A, B = inputs[f"A/{key}"], inputs[f"B/{key}"]
    kw = {"a_sparse": dense_to_block_ell(A, 8)} if op.needs_pack else {}
    out["C/" + c["id"]] = np.asarray(
        jax.jit(lambda a, b, op=op, kw=kw: op.apply(a, b, **kw))(A, B))
np.savez(sys.argv[3], **out)
"""


def _operands(m: int, n: int):
    """A at ~20% block density (so ``auto`` picks block_sparse), B dense."""
    rng = np.random.default_rng(100 * m + n)
    r, t = 8 * m, 12 * n
    mask = rng.random((S // BS, r // BS)) < 0.2
    A = (rng.standard_normal((S, r)) * np.kron(mask, np.ones((BS, BS)))
         ).astype(np.float32)
    return A, rng.standard_normal((S, t)).astype(np.float32)


def _op(case, plan, out_sharded: bool):
    cfg = CodedMatmulConfig(scheme="sparse_code", backend=case["backend"],
                            compute_dtype=case["compute_dtype"], out_sharded=out_sharded)
    return from_plan(cfg, plan)


def _survive(op, case):
    return op if case["mask"] is None else op.with_survivors(
        np.asarray(case["mask"], dtype=bool))


# ------------------------------- in the ranks ---------------------------------

def _cases_rank(device, cases, plans):
    """Every case in both layouts on this rank of the world group, then the
    refusal of a group of another size.  Returns numpy only."""
    import torch.distributed as dist

    world = dist.group.WORLD
    out = {"C": {}, "shard": {}, "repr": None}
    for case in cases:
        plan = plans[f"m{case['m']}n{case['n']}"]
        A, B = _operands(case["m"], case["n"])
        for layout in LAYOUTS:
            op = _survive(_op(case, plan, layout == "sharded").bind(device, group=world), case)
            res = op(A, B)
            if layout == "sharded":
                out["shard"][case["id"]] = res.numpy().copy()
                res = pcm.gather_blocks(res, op.plan_, world)
            out["C"][(case["id"], layout)] = res.numpy().copy()
    out["repr"] = repr(op)
    from repro_torch.runtime import run_device_job

    A, B = _operands(2, 2)
    rep = run_device_job(A, B, plans["m2n2"], device=device, backend="block_sparse",
                         repeats=2, group=world)
    out["device_job"] = (rep.blocks[0].numpy().copy(), rep.total_time)
    half = dist.new_group(list(range(WORKERS // 2)))  # every rank makes it
    if dist.get_rank() < WORKERS // 2:
        try:
            _op(cases[0], plans["m2n2"], False).bind(device, group=half)
        except ValueError as exc:
            out["refused"] = str(exc)
    return out


def _sleep_past_the_limit(device, pid_dir):
    pathlib.Path(pid_dir, str(os.getpid())).touch()
    time.sleep(600)


def _fail_on_rank_1(device, pid_dir):
    import torch.distributed as dist

    pathlib.Path(pid_dir, str(os.getpid())).touch()
    if dist.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    dist.barrier()  # rank 0 waits here for a rank that never comes


# -------------------------------- fixtures ------------------------------------

@pytest.fixture(scope="session")
def jax_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("group")
    inputs = {}
    for m, n in {(c["m"], c["n"]) for c in CASES}:
        inputs[f"A/m{m}n{n}"], inputs[f"B/m{m}n{n}"] = _operands(m, n)
    np.savez(tmp / "inputs.npz", **inputs)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "inputs.npz"),
         json.dumps(CASES), str(tmp / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="session")
def plans(jax_results):
    """The reference's own plans, carried across."""
    out = {}
    for m, n in {(c["m"], c["n"]) for c in CASES}:
        key = f"m{m}n{n}"
        fields = {f: jax_results[f"plan/{key}/{f}"]
                  for f in ("cols", "weights", "decode", "max_degree")}
        out[key] = plan_from_numpy({**fields, "m": m, "n": n, "num_workers": WORKERS})
    return out


@pytest.fixture(scope="session")
def ranks(plans):
    """Every rank's results: one launch of the 8-rank gloo group."""
    return workergroup.spawn_group(_cases_rank, WORKERS, backend="gloo", device="cpu",
                                   timeout=LAUNCH_TIMEOUT_S, args=(CASES, plans))


def _one_process(case, plans):
    A, B = _operands(case["m"], case["n"])
    op = _survive(_op(case, plans[f"m{case['m']}n{case['n']}"], False).bind("cpu"), case)
    return op(A, B).numpy()


# ---------------------------------- parity ------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_group_matches_jax_in_both_layouts(jax_results, ranks, case):
    want = jax_results["C/" + case["id"]]
    scale = float(np.abs(want).max())
    for k, rank in enumerate(ranks):
        for layout in LAYOUTS:
            C = rank["C"][(case["id"], layout)]
            assert C.shape == want.shape == (8 * case["m"], 12 * case["n"])
            assert C.dtype == np.float32
            np.testing.assert_allclose(C, want, rtol=RTOL, atol=RTOL * scale,
                                       err_msg=f"rank {k} {layout}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_group_matches_the_one_process_apply(plans, ranks, case):
    want = _one_process(case, plans)
    tol = ONE_PROCESS_RTOL * float(np.abs(want).max())
    for k, rank in enumerate(ranks):
        for layout in LAYOUTS:
            got = rank["C"][(case["id"], layout)]
            assert np.abs(got - want).max() <= tol, (k, layout)
    # every rank of the group holds the same C
    for layout in LAYOUTS:
        for rank in ranks[1:]:
            np.testing.assert_array_equal(rank["C"][(case["id"], layout)],
                                          ranks[0]["C"][(case["id"], layout)])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_layout_is_the_references(plans, ranks, case):
    m, n = case["m"], case["n"]
    mn = m * n
    mn_pad = -(-mn // WORKERS) * WORKERS
    per = mn_pad // WORKERS
    C = _one_process(case, plans)
    br, bt = C.shape[0] // m, C.shape[1] // n
    blocks = C.reshape(m, br, n, bt).transpose(0, 2, 1, 3).reshape(mn, br, bt)
    padded = np.concatenate([blocks, np.zeros((mn_pad - mn, br, bt), np.float32)])
    tol = ONE_PROCESS_RTOL * float(np.abs(C).max())
    for k, rank in enumerate(ranks):
        shard = rank["shard"][case["id"]]
        assert shard.shape == (per, br, bt) and shard.dtype == np.float32
        assert np.abs(shard - padded[k * per:(k + 1) * per]).max() <= tol, k
        for j in range(per):
            if k * per + j >= mn:  # a pad block: nobody contributes to it
                assert not shard[j].any(), (k, j)


def test_one_process_path_ignores_the_layout_bitwise(plans):
    """With no group both layouts are the same sum, bit for bit."""
    case = CASES[4]
    A, B = _operands(case["m"], case["n"])
    plan = plans["m2n2"]
    rep = _op(case, plan, False).bind("cpu")(A, B)
    sh = _op(case, plan, True).bind("cpu")(A, B)
    assert torch.equal(rep, sh)


# --------------------------- the device pack a rank ---------------------------

def test_a_rank_holds_only_its_workers_tiles(plans):
    A, _ = _operands(2, 2)
    pack = pcm.pack_worker_tiles(dense_to_block_ell(A, BS), plans["m2n2"])
    full = pcm.DeviceTilePack.from_pack(pack, torch.device("cpu"))
    one = pcm.DeviceTilePack.from_pack(pack, torch.device("cpu"), workers=[3])
    assert one.workers == (3,) and one.row(3) == 0 and full.row(3) == 3
    for f in ("vals", "src", "wslot", "slot_of"):
        assert getattr(one, f).shape[0] == 1
        assert torch.equal(getattr(one, f)[0], getattr(full, f)[3])
    cache = pack_cache.PackCache()
    a = cache.device_pack(pack, torch.device("cpu"), (3,))
    assert cache.device_pack(pack, torch.device("cpu"), [3]) is a
    assert cache.device_pack(pack, torch.device("cpu")) is not a
    assert cache.stats()["hits"] == 1 and cache.stats()["device_entries"] == 2


# --------------------------------- refusals -----------------------------------

def test_bind_refuses_a_group_of_another_size(ranks):
    for k, rank in enumerate(ranks):
        if k < WORKERS // 2:
            assert rank["refused"] == "worker group model=4 ranks != plan workers 8"
        else:
            assert "refused" not in rank
    assert "model=rank 0 of 8" in ranks[0]["repr"]


def test_run_device_job_in_a_rank_runs_its_worker(plans, ranks):
    A, B = _operands(2, 2)
    want = from_plan(CodedMatmulConfig(backend="block_sparse"), plans["m2n2"]).bind("cpu")(A, B)
    for rank in ranks:
        C, seconds = rank["device_job"]
        assert np.abs(C - want.numpy()).max() <= ONE_PROCESS_RTOL * float(want.abs().max())
        assert seconds > 0.0


def test_nccl_needs_a_card_a_rank_and_names_gloo(tmp_path):
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        workergroup.rank_device(0, 2, "nccl")
    with pytest.raises(ValueError, match="backend='gloo'"):
        workergroup.rank_device(0, 2, "nccl", "cpu")
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        workergroup.spawn_group(_sleep_past_the_limit, 2, backend="nccl", args=(str(tmp_path),))
    assert list(tmp_path.iterdir()) == []  # refused before any rank started
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        workergroup.init_worker_group(0, 2, backend="nccl", init_method="tcp://127.0.0.1:1")
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="not in"):
        workergroup.rank_device(0, 2, "mpi", "cpu")


def _gone(pids, within: float = 10.0) -> bool:
    deadline = time.monotonic() + within
    while time.monotonic() < deadline:
        if not any(pathlib.Path(f"/proc/{pid}").exists() for pid in pids):
            return True
        time.sleep(0.05)
    return False


@pytest.mark.parametrize("fn, error, match", [
    (_sleep_past_the_limit, TimeoutError, "wall limit"),
    (_fail_on_rank_1, RuntimeError, "rank 1 failed(.|\n)*rank 1 gives up"),
], ids=["past-the-wall-limit", "a-rank-fails"])
def test_a_failed_launch_raises_and_leaves_no_process(tmp_path, ranks, fn, error, match):
    # ``ranks`` first: the fork server is up, so the limit is the rank's alone
    t0 = time.monotonic()
    with pytest.raises(error, match=match):
        workergroup.spawn_group(fn, 2, backend="gloo", device="cpu", timeout=6.0,
                                args=(str(tmp_path),))
    assert time.monotonic() - t0 < 20.0
    pids = [int(p.name) for p in tmp_path.iterdir()]
    assert len(pids) == 2 and _gone(pids), pids


# ------------------------------- run_group_job --------------------------------

@pytest.mark.parametrize("out_sharded, mask", [(False, None), (True, _dead(3))],
                         ids=["replicated-all-alive", "sharded-worker-3-dead"])
def test_run_group_job_on_the_cpu(plans, out_sharded, mask):
    from repro_torch.runtime import run_group_job

    A, B = _operands(2, 3)
    plan = plans["m2n3"]
    rep = run_group_job(A, B, plan, backend="gloo", device="cpu", out_sharded=out_sharded,
                        survivors=mask, repeats=2, a_sparse=dense_to_block_ell(A, BS),
                        timeout=LAUNCH_TIMEOUT_S)
    op = from_plan(CodedMatmulConfig(backend="block_sparse"), plan).bind("cpu")
    want = (op if mask is None else op.with_survivors(np.asarray(mask)))(A, B)
    (C,) = rep.blocks
    assert C.device.type == "cpu" and C.shape == want.shape
    assert float((C - want).abs().max()) <= ONE_PROCESS_RTOL * float(want.abs().max())
    stats = rep.decode_stats
    assert {k: stats[k] for k in ("group", "backend", "out_sharded", "collective_path")} == {
        "group": WORKERS, "backend": "gloo", "out_sharded": out_sharded,
        "collective_path": "gloo on cpu tensors"}
    assert [r["rank"] for r in stats["ranks"]] == list(range(WORKERS))
    for r in stats["ranks"]:
        assert all(len(r["samples"][k]) == 2 and r[k] >= 0.0
                   for k in ("kernel_ms", "collective_ms", "apply_ms"))
        assert r["shard_shape"] == ([1, 8, 12] if out_sharded else [16, 36])
        assert not any(r["launches"].values())  # the CPU lane launches nothing
    assert rep.workers_used == (7 if mask else 8) and rep.num_workers == WORKERS
    assert rep.total_time == max(r["apply_ms"] for r in stats["ranks"]) / 1e3
