"""The six examples' PyTorch counterparts, on the CPU.

* each ``examples/*_torch.py`` runs as its own process with ``--device
  cpu`` (``train_lm_torch.py`` at ``--tiny --steps 10``), exits 0 and
  prints its ``OK`` line;
* the quickstart's host path: its code's generator matrix ``M`` and its
  decoded blocks are bit for bit those of the JAX package's
  ``get_scheme("sparse_code").instance(2, 3, 12, seed=0,
  distribution="wave_soliton")`` run through the reference's host decode
  on scipy blocks;
* the coded checkpoint demo restores exactly (error 0).
"""

from __future__ import annotations

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from repro.coded import get_scheme as jax_get_scheme  # noqa: E402
from repro.core.encoder import encode_blocks as jax_encode_blocks  # noqa: E402
from repro.core.encoder import make_tasks as jax_make_tasks  # noqa: E402
from repro.core.encoder import split_blocks as jax_split_blocks  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"

#: each example's arguments here, and the start of its last line
RUNS = {
    "quickstart": ([], "OK"),
    "straggler_sim": ([], "straggler never blocked the coded run: OK"),
    "chaos_demo": ([], "killed worker 1 mid-chunk; decoded from survivors: OK"),
    "serve_demo": ([], "OK: all requests completed exactly"),
    "train_lm": (["--tiny", "--steps", "10"], "OK: trained lm-100m (reduced) to step 10"),
    "coded_checkpoint_demo": ([], "OK: checkpoint survived losing 4/14 storage targets"),
}


def run_example(stem: str, *args: str, timeout: float = 120.0) -> subprocess.CompletedProcess:
    # one intra-op thread: the suite's other workers share the host's cores
    # (the pools' workers take one each already)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, str(EXAMPLES / f"{stem}_torch.py"), *args],
                          capture_output=True, text=True, timeout=timeout, cwd=ROOT, env=env)


def test_every_example_has_its_counterpart():
    originals = {p.stem for p in EXAMPLES.glob("*.py") if not p.stem.endswith("_torch")}
    assert originals == set(RUNS)
    assert {p.stem.removesuffix("_torch") for p in EXAMPLES.glob("*_torch.py")} == set(RUNS)


@pytest.mark.parametrize("stem", sorted(RUNS))
def test_example_runs_to_its_ok_line_on_the_cpu(stem, tmp_path):
    args, last = RUNS[stem]
    if stem == "train_lm":
        args = [*args, "--ckpt-dir", str(tmp_path)]
    proc = run_example(stem, *args, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1].startswith(last), proc.stdout[-2000:]
    if stem == "coded_checkpoint_demo":
        assert "max restore error: 0.00e+00" in lines  # exact, not merely within 1e-4
    if stem == "serve_demo":
        assert "fault ledger kinds: ['crash_detected', 'kill']" in lines


def _load(stem: str):
    spec = importlib.util.spec_from_file_location(f"{stem}_torch", EXAMPLES / f"{stem}_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_host_path_is_the_references_bit_for_bit():
    quickstart = _load("quickstart")
    code, blocks = quickstart.host_path(torch.device("cpu"))
    ref = jax_get_scheme("sparse_code").instance(2, 3, 12, seed=0, distribution="wave_soliton")
    for attr in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(code.M, attr), getattr(ref.M, attr))
    assert code.worker_rows == ref.worker_rows

    A = sp.random(4000, 1800, density=0.01, format="csc", random_state=np.random.RandomState(0))
    B = sp.random(4000, 2400, density=0.01, format="csc", random_state=np.random.RandomState(1))
    A_blocks, B_blocks = jax_split_blocks(A, 2), jax_split_blocks(B, 3)
    results = [jax_encode_blocks(t, A_blocks, B_blocks, 3) for t in jax_make_tasks(ref.M)]
    finished = [k for k in range(12) if k not in (3, 7)]
    want = ref.decode(finished, dict(enumerate(results)))
    assert len(blocks) == len(want) == 6
    for got, exp in zip(blocks, want):
        exp = exp.toarray() if sp.issparse(exp) else np.asarray(exp)
        assert got.dtype == torch.float64
        assert np.array_equal(quickstart._dense(got), exp)
