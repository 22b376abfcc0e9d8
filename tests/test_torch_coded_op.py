"""The slice as a whole: the port's ``CodedOp`` against the JAX package's.

One subprocess (8 host devices, so the JAX op runs its real shard_map
program over an 8-worker mesh) applies ``repro.coded.CodedOp`` to every
case below and writes the results and the plans it used to an ``.npz``.
The port, fed the very same plans through ``plan_from_numpy`` and the same
A and B, must give the same C on the CPU (``bind("cpu")``).

The JAX package's scatter layout (``out_sharded``: a psum_scatter, then a
slice of the sharded blocks) does not run on the jax this suite runs on
(ROADMAP section 3 lists the reference's failures here); by the
reference's own contract it gives the replicated layout's C bit for bit,
so the port's ``out_sharded`` C is held against JAX's replicated C.

Tolerance: both compute in f32 from the same plan and the same (bf16-
rounded, where asked) tiles, and differ in the order of their f32 sums
(slot loop vs einsum, a torch sum vs a psum over the workers).  The decode
amplifies that by at most cond(M) ~ 10 here, so C agrees to 1e-5 of
max|C| -- far inside what a wrong slot, weight or decode column would
produce.
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
from repro_torch.coded.convert import plan_from_numpy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKERS, S, BS = 8, 64, 8
RTOL = 1e-5

_CHUNKS = np.ones((WORKERS, 2), dtype=bool)
_CHUNKS[4, 1] = _CHUNKS[6, 1] = False       # two workers finished half their slots
_CHUNKS = _CHUNKS.tolist()


def _dead(*workers):
    mask = np.ones(WORKERS, dtype=bool)
    mask[list(workers)] = False
    return mask.tolist()


# (backend, compute_dtype, out_sharded, survivors mask) -- run at both (m, n)
_MATRIX = [
    ("dense_scan", "float32", False, None),
    ("dense_scan", "float32", True, _dead(3)),
    ("dense_scan", "float32", False, _dead(1, 5)),
    ("dense_scan", "float32", False, _CHUNKS),
    ("block_sparse", "float32", False, None),
    ("block_sparse", "float32", False, _dead(3)),
    ("block_sparse", "float32", True, _dead(1, 5)),
    ("block_sparse", "float32", True, None),
    ("block_sparse", "float32", False, _CHUNKS),
    ("block_sparse", "bfloat16", False, None),
    ("block_sparse", "bfloat16", True, _dead(3)),
    ("auto", "float32", False, _dead(3)),
]
CASES = [dict(id=f"m{m}n{n}-{be}-{cd}-{'sharded' if sh else 'replicated'}-{i}",
              m=m, n=n, backend=be, compute_dtype=cd, out_sharded=sh, mask=mask)
         for m, n in [(2, 2), (2, 3)]
         for i, (be, cd, sh, mask) in enumerate(_MATRIX)]

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
    # staged under jit, as the package's own benchmark runs it: the tile
    # pack is host metadata, so it comes in as a BlockELL of A
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


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("coded_op")
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


@pytest.mark.parametrize("case", CASES, ids=[c["id"] for c in CASES])
def test_port_coded_op_matches_jax(jax_results, case):
    m, n = case["m"], case["n"]
    key = f"m{m}n{n}"
    fields = {f: jax_results[f"plan/{key}/{f}"]
              for f in ("cols", "weights", "decode", "max_degree")}
    p = plan_from_numpy({**fields, "m": m, "n": n, "num_workers": WORKERS})
    cfg = CodedMatmulConfig(scheme="sparse_code", backend=case["backend"],
                            compute_dtype=case["compute_dtype"],
                            out_sharded=case["out_sharded"])
    op = from_plan(cfg, p).bind("cpu")
    if case["mask"] is not None:
        op = op.with_survivors(np.asarray(case["mask"], dtype=bool))
    A, B = _operands(m, n)
    C = op(A, B)
    want = jax_results["C/" + case["id"]]
    assert C.shape == want.shape == (8 * m, 12 * n)
    assert C.dtype == torch.float32 and C.device.type == "cpu"
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(C.numpy(), want, rtol=RTOL, atol=RTOL * scale)
    if case["compute_dtype"] == "float32":
        # and both are the product itself
        np.testing.assert_allclose(C.numpy(), A.T @ B, rtol=1e-4,
                                   atol=1e-4 * scale)
