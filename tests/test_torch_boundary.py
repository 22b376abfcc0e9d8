"""The port's boundary: no JAX, no ``repro``, no hidden CPU carry-on.

* every ``repro_torch`` module, ``chip_smoke`` and ``chip_variants`` import
  in a process where ``jax``, ``ml_dtypes`` and ``repro`` cannot be
  imported at all;
* no port file names them;
* ``bind()`` with no CUDA device raises instead of running on the CPU, and
  so do the runtime's entry points (``run_coded_job``, ``run_live_job``,
  ``JobMux``, ``run_device_job``, the process runtime's ``run_proc_job``,
  ``ProcPool`` and ``MuxProcPool``) and ``coded_matmul`` unless given
  ``device="cpu"``;
* a kernel wrapper given CPU tensors takes the plain version and never
  reaches the CUDA lane, while the CUDA wrapper refuses CPU tensors;
* ``chip_smoke.py`` fails, printing no result, where it cannot run.
"""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[name] = None          # any import of them now raises
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import chip_variants
from repro_torch import CodedMatmulConfig, CodedOp, plan
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro")))
assert not leaked, leaked
print(len(names))
"""


def test_every_port_module_imports_without_jax_or_repro():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL, str(ROOT / "src"), str(ROOT)],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    # the walk found the whole package (core, coded, sparse, kernels, runtime)
    assert int(proc.stdout.split()[-1]) >= 20


_FORBIDDEN = re.compile(
    r"\bimport\s+jax\b|\bfrom\s+jax\b|\bml_dtypes\b|(?<![\w/])repro\.")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*PORT.rglob("*.py"), *PORT.rglob("*.cu"), ROOT / "chip_smoke.py",
     ROOT / "chip_variants.py"]))
def test_port_sources_name_no_jax_and_no_repro(path):
    text = (ROOT / path).read_text()
    hits = [m.group(0) for m in _FORBIDDEN.finditer(text)]
    assert not hits, f"{path} names {hits}"


def test_bind_without_cuda_raises_instead_of_using_the_cpu():
    from repro_torch.coded import CodedMatmulConfig, plan

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: bind() is meant to succeed")
    op = plan(CodedMatmulConfig(backend="block_sparse"), 2, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        op.bind()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        op.bind("cuda")
    assert op.bind("cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="unbound"):
        op.apply(np.zeros((16, 16), np.float32), np.zeros((16, 24), np.float32))


def _entry_point_calls():
    """Each entry point of the runtime, as a call taking ``device``."""
    import warnings

    from repro_torch.core import coded_matmul, schemes
    from repro_torch.runtime import (JobMux, MuxJob, MuxProcPool, ProcPool, SlowWorkers,
                                     run_coded_job, run_device_job, run_live_job,
                                     run_proc_job)

    rng = np.random.default_rng(0)
    blocks = [rng.standard_normal((3, 4)) for _ in range(4)]
    Ab = [rng.standard_normal((6, 2)) for _ in range(2)]
    Bb = [rng.standard_normal((6, 3)) for _ in range(2)]
    code = schemes.sparse_code(2, 2, 8, seed=1)
    A = rng.standard_normal((16, 16)).astype(np.float32)
    B = rng.standard_normal((16, 24)).astype(np.float32)
    p = coded_matmul.make_plan(2, 2, 8)

    def mux(source, device):
        with JobMux(8, source=source, device=device) as m:
            return m.run([MuxJob(code=code, A_blocks=Ab, B_blocks=Bb, n=2)],
                         raise_on_error=True)

    def legacy(device):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return coded_matmul.coded_matmul(A, B, p, device=device)

    one = schemes.uncoded(1, 1)  # one worker process: the cheapest real job
    A1, B1 = [rng.standard_normal((6, 2))], [rng.standard_normal((6, 3))]

    return {
        "run_coded_job": lambda d: run_coded_job(code, blocks, SlowWorkers(1, 2.0),
                                                 device=d),
        "run_proc_job": lambda d: run_proc_job(one, A1, B1, 1, device=d),
        "ProcPool": lambda d: ProcPool(one, 1, A1, B1, 1, device=d),
        "MuxProcPool": lambda d: MuxProcPool(1, device=d),
        "JobMux proc": lambda d: JobMux(1, source=MuxProcPool(1, device=d), device=d),
        "run_live_job": lambda d: run_live_job(code, Ab, Bb, 2, device=d),
        "JobMux sim": lambda d: mux("sim", d),
        "JobMux live": lambda d: mux("live", d),
        "run_device_job": lambda d: run_device_job(A, B, p, device=d, repeats=1),
        "coded_matmul": legacy,
    }


@pytest.mark.parametrize("name", ["run_coded_job", "run_live_job", "JobMux sim",
                                  "JobMux live", "run_device_job", "coded_matmul",
                                  "run_proc_job", "ProcPool", "MuxProcPool",
                                  "JobMux proc"])
def test_entry_points_without_cuda_raise_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card is meant to be used")
    call = _entry_point_calls()[name]
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(device)
    assert call("cpu") is not None


def _operands(seed=0, CB=2, L=3, bs=8, s=32, n=2, bt=24, mn=4):
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.standard_normal((CB, L, bs, bs)).astype(np.float32))
    src = torch.from_numpy(np.stack([rng.integers(0, s // bs, (CB, L)),
                                     rng.integers(0, n, (CB, L))], -1).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((CB, L)).astype(np.float32))
    dvec = torch.from_numpy(rng.standard_normal(mn).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((s, n * bt)).astype(np.float32))
    return vals, src, w, dvec, B


def _accum_operands(seed=0, s=128, r=16, t=24, L=3):
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.standard_normal((s, r)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((s, t)).astype(np.float32))
    cols = torch.from_numpy(rng.integers(0, 4, L).astype(np.int32))
    weights = torch.from_numpy(rng.standard_normal(L).astype(np.float32))
    return A, B, cols, weights


def test_cpu_tensors_never_reach_the_cuda_lane(monkeypatch):
    from repro_torch.kernels import build, coded_accum, ops, ref, spmm_block

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU lane reached the CUDA kernel")

    monkeypatch.setattr(build, "load_library", refuse)
    for name in ("spmm_block_fused", "spmm_block_fused_decode", "spmm_block"):
        monkeypatch.setattr(spmm_block, name, refuse)
    monkeypatch.setattr(coded_accum, "coded_accum", refuse)
    before = dict(spmm_block.LAUNCHES), dict(coded_accum.LAUNCHES)
    vals, src, w, dvec, B = _operands()
    two = ops.spmm_block_fused(vals, src, w, B, bt=24)
    fused = ops.spmm_block_fused_decode(vals, src, w, dvec, B, bt=24)
    assert torch.equal(two, ref.spmm_block_fused_ref(vals, src, w, B, 24))
    assert torch.equal(fused, dvec[:, None, None] * two[None])
    idx = src[..., 0].contiguous()
    B16 = B[:, :16].contiguous()
    assert torch.equal(ops.spmm_block(vals, idx, B16, t_tile=16),
                       ref.spmm_block_ref(vals, idx, B16))
    A, B2, cols, weights = _accum_operands()
    assert torch.equal(ops.coded_accum(A, B2, cols, weights, m=2, n=2),
                       ref.coded_accum_ref(A, B2, cols, weights, 2, 2))
    assert (dict(spmm_block.LAUNCHES), dict(coded_accum.LAUNCHES)) == before


def test_cuda_wrappers_refuse_cpu_tensors_and_count_nothing():
    from repro_torch.kernels import coded_accum, spmm_block

    before = dict(spmm_block.LAUNCHES), dict(coded_accum.LAUNCHES)
    vals, src, w, dvec, B = _operands()
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmm_block.spmm_block_fused(vals, src, w, B, bt=24)
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmm_block.spmm_block_fused_decode(vals, src, w, dvec, B, bt=24)
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmm_block.spmm_block(vals, src[..., 0].contiguous(), B)
    with pytest.raises(ValueError, match="CUDA tensor"):
        coded_accum.coded_accum(*_accum_operands(), m=2, n=2)
    assert (dict(spmm_block.LAUNCHES), dict(coded_accum.LAUNCHES)) == before


def test_mixed_devices_and_unknown_lanes_are_refused():
    from repro_torch.kernels import ops

    vals, src, w, dvec, B = _operands()
    with pytest.raises(ValueError, match="no kernel lane"):
        ops.spmm_block_fused(vals.to("meta"), src.to("meta"), w.to("meta"),
                             B.to("meta"), bt=24)
    with pytest.raises(ValueError, match="several devices"):
        ops.spmm_block_fused(vals.to("meta"), src, w, B, bt=24)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_printing_a_result(tmp_path, alone):
    """Here (no card) and in a directory holding chip_smoke.py alone, the
    script exits nonzero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = ROOT
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=120, cwd=cwd)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
