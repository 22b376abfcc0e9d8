"""The port's structural contracts and analysis CLI against the JAX package's.

The reference's passes walk staged jaxprs, and its walker cannot run on
this box: ``jaxpr_check._sub_jaxprs`` imports ``ClosedJaxpr`` from
``jax.core``, which jax 0.9 no longer has (``jaxpr_check.py:45``), so any
real jaxpr with a parametrised equation fails in it.  So the comparison
goes through the functions it does expose on plain data:

* ``nnz_proportional_budget`` ``==`` the reference's for every scheme, on
  the reference's own plan and pack (and the port's);
* the reference's ``verify_staged_program`` / ``verify_fused_epilogue`` run
  over the port's captured programs, each record presented as a jaxpr
  equation with no parameters (so its walker never reaches
  ``_sub_jaxprs``): the same rule names, severities and anchors (each
  package's own ``stage_coded_matmul``) where the rules share a meaning;
  the reference's ``collective-axis`` and the port's ``worker-combine``
  do not (one card has no collective);
* each detector trips on its probe, as ``tests/test_analysis.py`` checks
  the reference's, and a blinded detector fails the run;
* the kernel scope: an entry point's call is one record on the CPU lane,
  and its result is unchanged;
* the CLI: ``--strict --device cpu`` exits 0 with contracts at 54 (30
  programs in its process, 24 in the ranks of its worker group),
  ``--only schemes`` checks that layer alone, ``fused_decode`` turned off
  gives ``one-launch-epilogue`` errors and exit 1, and a layer that checks
  nothing exits 2.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import jaxpr_check as jc  # noqa: E402
from repro.coded import registry as jreg  # noqa: E402
from repro.core import coded_matmul as jcm  # noqa: E402
from repro.sparse import dense_to_block_ell as j_dense_to_block_ell  # noqa: E402

from repro_torch.analysis import __main__ as cli  # noqa: E402
from repro_torch.analysis import contracts as pc  # noqa: E402
from repro_torch.coded import CodedMatmulConfig, from_plan  # noqa: E402
from repro_torch.coded import registry as preg  # noqa: E402
from repro_torch.core import coded_backends  # noqa: E402
from repro_torch.core import coded_matmul as pcm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.sparse import dense_to_block_ell  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
S, R, T, BS, M, N_BLK = 32, 16, 24, 8, 2, 2
BR, BT = R // M, T // N_BLK


def _operands():
    """The CLI geometry's operands, as ``run_contract_checks`` makes them."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((S, R)).astype(np.float32)
    mask = rng.random((S // BS, R // BS)) < 0.5
    A *= np.kron(mask, np.ones((BS, BS), np.float32))
    B = rng.standard_normal((S, T)).astype(np.float32)
    return A, B


def _workers(registry, name):
    sch = registry.get_scheme(name)
    return None if sch.fixed_workers else pc.FREE_WORKERS


DEVICE_SCHEMES = [name for name in preg.scheme_names() if name != "mds"]


def test_device_capable_schemes_are_the_references():
    assert DEVICE_SCHEMES == [name for name in jreg.scheme_names() if name != "mds"]
    with pytest.raises(ValueError):
        preg.get_scheme("mds").plan(2, 2, 8, seed=5)


# ----------------------------- the byte budget -------------------------------

@pytest.mark.parametrize("name", DEVICE_SCHEMES)
def test_budget_equals_the_reference_on_its_own_plan_and_pack(name):
    A, _ = _operands()
    jplan = jreg.get_scheme(name).plan(M, N_BLK, _workers(jreg, name), seed=5)
    jpack = jcm.pack_worker_tiles(j_dense_to_block_ell(A, block_size=BS), jplan)
    want = jc.nnz_proportional_budget(jplan, jpack, S, R, T)
    assert pc.nnz_proportional_budget(jplan, jpack, S, R, T) == want
    assert pc.nnz_proportional_budget(jplan, jpack, S, R, T, slack=3.0) == \
        jc.nnz_proportional_budget(jplan, jpack, S, R, T, slack=3.0)
    assert pc.nnz_proportional_budget(jplan, None, S, R, T) == \
        jc.nnz_proportional_budget(jplan, None, S, R, T)
    pplan = preg.get_scheme(name).plan(M, N_BLK, _workers(preg, name), seed=5)
    ppack = pcm.pack_worker_tiles(dense_to_block_ell(A, block_size=BS), pplan)
    assert pc.nnz_proportional_budget(pplan, ppack, S, R, T) == want


# --------------------- findings beside the reference's -----------------------

_NP = {torch.float32: np.float32, torch.float64: np.float64, torch.int32: np.int32,
       torch.int64: np.int64, torch.bool: np.bool_}
#: the JAX primitive a recorded op stands for, where the reference's passes
#: read the primitive's name
_PRIM = {"mul": "mul", "mul_": "mul", "mm": "dot_general", "bmm": "dot_general",
         "addmm": "dot_general", "baddbmm": "dot_general", "expand": "broadcast_in_dim"}


def as_jaxpr(program):
    """A captured program as the reference's passes read a closed jaxpr:
    an equation a record, with no parameters, a kernel record as a
    ``pallas_call``."""
    def var(aval):
        shape, dtype = aval
        return SimpleNamespace(aval=SimpleNamespace(shape=shape, dtype=np.dtype(_NP[dtype])))

    return SimpleNamespace(jaxpr=SimpleNamespace(eqns=[
        SimpleNamespace(primitive=SimpleNamespace(
                            name="pallas_call" if rec.kernel else _PRIM.get(rec.op, rec.op)),
                        params={}, invars=[var(a) for a in rec.inputs],
                        outvars=[var(a) for a in rec.outputs])
        for rec in program]))


#: the reference's rule that has no counterpart on one card, and the
#: port's that stands in its place
_UNSHARED = ("collective-axis", "worker-combine")


def _key(findings, anchor_line):
    assert all(f.path == "core/coded_matmul.py" and f.line == anchor_line for f in findings)
    return sorted((f.rule, f.severity) for f in findings if f.rule not in _UNSHARED)


def _anchors():
    import inspect

    return (inspect.getsourcelines(pcm.stage_coded_matmul)[1],
            inspect.getsourcelines(jcm.stage_coded_matmul)[1])


def _live_program(name, backend):
    A, B = _operands()
    plan = preg.get_scheme(name).plan(M, N_BLK, _workers(preg, name), seed=5)
    ell = dense_to_block_ell(A, block_size=BS)
    op = from_plan(CodedMatmulConfig(backend=backend), plan).bind(CPU)
    kw = {"a_sparse": ell} if backend == "block_sparse" else {}
    program, _ = pc.capture_apply(op, torch.from_numpy(A), torch.from_numpy(B), **kw)
    return program, plan, pc.nnz_proportional_budget(plan, pcm.pack_worker_tiles(ell, plan),
                                                     S, R, T)


CASE_NAMES = [f"{name}-{backend}" for name in DEVICE_SCHEMES
              for backend in ("dense_scan", "block_sparse")] + [
    "legacy-stacked-gather", "float64-combine", "over-budget"]


def _case(case):
    """(program, num_workers, stacked_rows, byte_budget, expected shared rules)."""
    if case == "legacy-stacked-gather":
        program, _ = pc.capture(pc.legacy_stacked_gather, torch.zeros((S, T)), 6, S, 2, 12)
        return program, 8, 6 * S, None, [("no-dense-materialization", "error")]
    if case == "float64-combine":
        program, _ = pc.capture(pc.float64_decode_combine, torch.zeros(4), torch.zeros((BR, BT)))
        return program, 8, None, None, [("dtype-policy", "error")]
    if case == "over-budget":
        program, _ = pc.capture(pc.over_budget_op, 4096)
        return program, 8, None, 4096, [("memory-budget", "error")]
    name, backend = case.rsplit("-", 1)
    program, plan, budget = _live_program(name, backend)
    sparse = backend == "block_sparse"
    return (program, plan.num_workers,
            plan.max_degree * S if sparse and plan.max_degree > 1 else None,
            budget if sparse else None, [])


@pytest.mark.parametrize("case", CASE_NAMES)
def test_staged_program_findings_match_the_reference(case):
    program, workers, rows, budget, want = _case(case)
    port_line, ref_line = _anchors()
    got = pc.verify_staged_program(program, num_workers=workers, stacked_rows=rows,
                                   byte_budget=budget, context=case)
    ref = jc.verify_staged_program(as_jaxpr(program), axis_name="model",
                                   stacked_rows=rows, byte_budget=budget, context=case)
    assert _key(got, port_line) == _key(ref, ref_line) == want
    assert all(f.layer == "contracts" for f in got)
    # the live programs sum every worker; the probes do not
    assert ("worker-combine" in {f.rule for f in got}) == (case not in CASE_NAMES[:-3])


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", DEVICE_SCHEMES)
def test_one_launch_findings_match_the_reference(name, fused, monkeypatch):
    monkeypatch.setattr(coded_backends.get_backend("block_sparse"), "fused_decode", fused)
    program, _, _ = _live_program(name, "block_sparse")
    port_line, ref_line = _anchors()
    got = pc.verify_fused_epilogue(program, mn=M * N_BLK, br=BR, context=name)
    ref = jc.verify_fused_epilogue(as_jaxpr(program), mn=M * N_BLK, br=BR, context=name)
    assert _key(got, port_line) == _key(ref, ref_line) == (
        [] if fused else [("one-launch-epilogue", "error")] * 2)


# ---------------------------- each detector's probe ---------------------------

def test_stacked_detector_and_sensitivity_probe():
    L, s, n, bt = 5, 16, 2, 8
    program, out = pc.capture(pc.legacy_stacked_gather, torch.ones((s, n * bt)), L, s, n, bt)
    assert out.shape == (L * s, bt)
    assert pc.stacked_intermediates(program, L * s)
    pc.assert_detector_sensitivity(L, s, n, bt)  # must not raise
    clean, _ = pc.capture(lambda b: b @ b.T, torch.ones((s, n * bt)))
    assert pc.stacked_intermediates(clean, L * s) == []


def test_decode_detector_skips_the_kernel_records_and_finds_their_launches():
    mn, CB, L = 4, 1, 3
    rng = np.random.default_rng(1)
    vals = torch.from_numpy(rng.standard_normal((CB, L, BS, BS)).astype(np.float32))
    src = torch.zeros((CB, L, 2), dtype=torch.int32)
    w, dvec = torch.ones((CB, L)), torch.arange(1.0, mn + 1)
    B = torch.from_numpy(rng.standard_normal((S, T)).astype(np.float32))
    fused, _ = pc.capture(ops.spmm_block_fused_decode, vals, src, w, dvec, B, bt=BT)
    assert pc.decode_contraction_offenders(fused, mn, CB * BS) == []
    assert pc.fused_epilogue_launches(fused, mn) == [(mn, CB * BS, BT)]
    legacy, _ = pc.capture(pc.legacy_decode_combine, dvec, torch.ones((CB * BS, BT)))
    assert pc.decode_contraction_offenders(legacy, mn, CB * BS) == [("mul", (mn, CB * BS, BT))]
    assert pc.fused_epilogue_launches(legacy, mn) == []
    assert pc.decode_contraction_offenders(legacy, 1, CB * BS) == []
    pc.assert_decode_detector_sensitivity(mn, CB * BS, BT)


def test_worker_combine_pass():
    Nw, mn = 8, 4
    contribs = [torch.full((mn, BR, BT), float(k)) for k in range(Nw)]
    summed, out = pc.capture(lambda c: torch.stack(c).sum(dim=0), contribs)
    assert torch.equal(out, torch.full((mn, BR, BT), 28.0))
    assert pc.worker_combines(summed, Nw) == [("sum", (Nw, mn, BR, BT), (mn, BR, BT))]
    assert pc.worker_combines(summed, Nw - 1) == []
    alone, out = pc.capture(pc.worker_zero_alone, contribs)
    assert torch.equal(out, contribs[0]) and pc.worker_combines(alone, Nw) == []
    pc.assert_combine_detector_sensitivity(Nw, mn, BR, BT)


def test_float64_pass():
    program, _ = pc.capture(lambda x: (x.double() * 2.0).sum(), torch.ones(4))
    assert ("mul", (4,), "float64") in pc.float64_offenders(program)
    clean, _ = pc.capture(lambda x: (x * 2.0).sum(), torch.ones(4))
    assert pc.float64_offenders(clean) == []
    pc.assert_dtype_detector_sensitivity(4, BR, BT)


def test_peak_bytes_pass():
    program, _ = pc.capture(lambda a, b: a @ b, torch.ones((8, 4)), torch.ones((4, 2)))
    peak, op, shapes = pc.peak_equation_bytes(program)
    assert op == "mm" and shapes == [(8, 4), (4, 2), (8, 2)]
    assert peak == 4 * (8 * 4 + 4 * 2 + 8 * 2)
    assert pc.peak_equation_bytes([]) == (0, "<empty>", [])
    program, _ = pc.capture(pc.over_budget_op, 4096)
    assert pc.peak_equation_bytes(program)[0] > 4096
    pc.assert_budget_detector_sensitivity(4096)


_BLIND = {
    "no-dense-materialization": ("stacked_intermediates", lambda *a: []),
    "one-launch-epilogue": ("decode_contraction_offenders", lambda *a: []),
    "worker-combine": ("worker_combines", lambda *a: [("sum", (), ())]),
    "dtype-policy": ("float64_offenders", lambda *a: []),
    "memory-budget": ("peak_equation_bytes", lambda *a: (0, "<empty>", [])),
}


@pytest.mark.parametrize("rule", sorted(_BLIND))
def test_a_blind_detector_fails_the_run(rule, monkeypatch):
    attr, blind = _BLIND[rule]
    monkeypatch.setattr(pc, attr, blind)
    findings, programs = pc.run_contract_checks(CPU)
    assert programs == 0 and [(f.rule, f.severity) for f in findings] == [(rule, "error")]
    assert "lost sensitivity" in findings[0].message


# ------------------------------- the kernel scope -----------------------------

def test_an_entry_point_is_one_record_and_its_result_is_unchanged():
    rng = np.random.default_rng(2)
    vals = torch.from_numpy(rng.standard_normal((2, 3, BS, BS)).astype(np.float32))
    src = torch.from_numpy(np.stack([rng.integers(0, S // BS, (2, 3)),
                                     rng.integers(0, 2, (2, 3))], -1).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32))
    dvec = torch.from_numpy(rng.standard_normal(4).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((S, T)).astype(np.float32))
    want = ops.spmm_block_fused_decode(vals, src, w, dvec, B, bt=BT)
    program, got = pc.capture(ops.spmm_block_fused_decode, vals, src, w, dvec, B, bt=BT)
    assert torch.equal(got, want)
    assert program == [pc.OpRecord(
        "spmm_block_fused_decode", "spmm_block_fused_decode",
        tuple((tuple(x.shape), x.dtype) for x in (vals, src, w, dvec, B)),
        (((4, 2 * BS, BT), torch.float32),), kernel=True)]
    two, _ = pc.capture(ops.spmm_block_fused, vals, src, w, B, bt=BT)
    assert [(r.name, r.kernel) for r in two] == [("spmm_block_fused", True)]
    assert ops.KERNEL_SCOPE.get() is None
    with pytest.raises(RuntimeError, match="inside"):
        pc.capture(lambda: (_ for _ in ()).throw(RuntimeError("inside")))
    assert ops.KERNEL_SCOPE.get() is None


def test_kernel_records_are_held_to_the_launches():
    program = [pc.OpRecord("spmm_block_fused_decode", "spmm_block_fused_decode", (), (), True),
               pc.OpRecord("aten.sum.dim_IntList", "sum", (), ())] * 2
    assert pc.kernel_launch_offenders(program, {"spmm_block_fused_decode": 2,
                                                "spmm_block": 0}) == []
    assert pc.kernel_launch_offenders(program, {"spmm_block_fused_decode": 0}) == [
        ("spmm_block_fused_decode", 2, 0)]
    assert pc.kernel_launch_offenders([], {"coded_accum": 1}) == [("coded_accum", 0, 1)]


# ------------------------------------ the CLI ---------------------------------

def test_cli_strict_on_the_cpu_passes_with_every_program():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict", "--device", "cpu",
         "--json", "-"], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout)
    assert report["checked"] == {"schemes": len(preg.scheme_names()), "contracts": 54}
    assert report["findings"] == [] and report["errors"] == report["warnings"] == 0
    assert report["launches"] == {"spmm_block_fused": 0, "spmm_block_fused_decode": 0,
                                  "spmm_block": 0, "coded_accum": 0}


def test_cli_only_schemes_checks_that_layer_alone(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert cli.main(["--only", "schemes", "--device", "cpu", "--json", str(out)]) == 0
    assert json.loads(out.read_text())["checked"] == {"schemes": len(preg.scheme_names())}
    assert "[schemes=7]" in capsys.readouterr().out


def test_cli_without_the_fused_decode_fails_the_one_launch_contract(monkeypatch, capsys):
    monkeypatch.setattr(coded_backends.get_backend("block_sparse"), "fused_decode", False)
    assert cli.main(["--only", "contracts", "--device", "cpu", "--json", "-"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["checked"] == {"contracts": 54}
    assert {(f["rule"], f["severity"], f["layer"]) for f in report["findings"]} == {
        ("one-launch-epilogue", "error", "contracts")}
    assert len(report["findings"]) == 2 * len(DEVICE_SCHEMES)


def test_cli_exits_2_when_a_layer_checks_nothing(monkeypatch, capsys):
    monkeypatch.setattr(preg, "scheme_names", lambda: ("mds",))
    assert cli.main(["--only", "contracts", "--device", "cpu"]) == 2
    assert "[contracts=0]" in capsys.readouterr().out


# ------------------------- the worker group's programs -------------------------

#: the reference's collective primitive each c10d op stands for
_COLLECTIVE_PRIM = {"allreduce_": "psum", "reduce_scatter_": "reduce_scatter"}


class _Params(dict):
    """An equation's params as the reference's passes read them: its axis
    pass ``get``s ``axes``; its walker finds no sub-jaxpr in ``values()``,
    which would reach the import that fails on this box."""

    def values(self):
        return ()


def as_group_jaxpr(program, group: str):
    """A rank's program as the reference reads a shard_map body: each
    collective a psum or reduce_scatter over the axis ``"model"`` when it
    names the worker group, over another axis when it does not."""
    closed = as_jaxpr(program)
    for eqn, rec in zip(closed.jaxpr.eqns, program):
        if rec.name.startswith("c10d."):
            eqn.primitive.name = _COLLECTIVE_PRIM[rec.op]
            eqn.params = _Params(axes=("model",) if rec.group == group
                                 else (f"process group {rec.group}",))
    return closed


def _group_programs(device, plans):
    """In each rank: every plan's backend x layout program over the world
    group or its half, the two collective probes' programs, the collective
    probe itself, and the probe and the ranks' run with the detector
    blinded.  Rank 0 and rank 4 (one in each half) return their programs."""
    import torch.distributed as dist

    world, rank = dist.group.WORLD, dist.get_rank()
    halves = [dist.new_group(list(range(i, i + 4))) for i in (0, 4)]
    half = halves[rank // 4]
    A, B = _operands()
    ell = dense_to_block_ell(A, block_size=BS)
    out = {"programs": {}}
    for name, plan in plans:
        group = world if plan.num_workers == 8 else half
        for backend in ("dense_scan", "block_sparse"):
            for sharded in (False, True):
                cfg = CodedMatmulConfig(backend=backend, out_sharded=sharded)
                op = from_plan(cfg, plan).bind(device, group=group)
                kw = {"a_sparse": ell} if backend == "block_sparse" else {}
                program, _ = pc.capture_apply(op, torch.from_numpy(A), torch.from_numpy(B), **kw)
                out["programs"][(name, backend, sharded)] = (program, group.group_name)
    contrib = torch.zeros((4, BR, BT))
    out["wrong-group"] = (pc.capture(pc.wrong_group_combine, contrib, world)[0], half.group_name)
    out["no-collective"] = (pc.capture(pc.uncombined, contrib)[0], half.group_name)
    pc.assert_collective_detector_sensitivity(half, world, 4, BR, BT)  # must not raise
    seeing = pc.collective_axis_problems
    pc.collective_axis_problems = lambda *a, **kw: []
    try:
        with pytest.raises(AssertionError, match="lost sensitivity") as blind:
            pc.assert_collective_detector_sensitivity(half, world, 4, BR, BT)
        out["blind"] = str(blind.value)
        out["blind_run"] = pc._group_programs_rank(device, *_operands(), ell, plans)
    finally:
        pc.collective_axis_problems = seeing
    return out if rank in (0, 4) else None


@pytest.fixture(scope="module")
def group_programs():
    from repro_torch.runtime.workergroup import spawn_group

    plans = [(name, preg.get_scheme(name).plan(M, N_BLK, _workers(preg, name), seed=5))
             for name in DEVICE_SCHEMES]
    ranks = spawn_group(_group_programs, 8, backend="gloo", device="cpu", timeout=120.0,
                        args=(plans,))
    return ranks[0], ranks[4], dict(plans)


GROUP_CASES = [(name, backend, sharded) for name in DEVICE_SCHEMES
               for backend in ("dense_scan", "block_sparse") for sharded in (False, True)]


def _all_key(findings, anchor_line):
    assert all(f.path == "core/coded_matmul.py" and f.line == anchor_line for f in findings)
    return sorted((f.rule, f.severity) for f in findings)


@pytest.mark.parametrize("case", GROUP_CASES,
                         ids=[f"{n}-{b}-{'sharded' if s else 'replicated'}"
                              for n, b, s in GROUP_CASES])
def test_group_program_findings_match_the_reference(group_programs, case):
    first, other, plans = group_programs
    name, backend, sharded = case
    plan = plans[name]
    port_line, ref_line = _anchors()
    sparse = backend == "block_sparse"
    A, _ = _operands()
    budget = pc.nnz_proportional_budget(
        plan, pcm.pack_worker_tiles(dense_to_block_ell(A, block_size=BS), plan), S, R, T)
    rows = plan.max_degree * S if sparse and plan.max_degree > 1 else None
    for rank in (first, other):
        program, group = rank["programs"][case]
        # the rank's one collective, of its layout's kind, over its own group
        assert pc.collectives(program) == [
            ("reduce_scatter_" if sharded else "allreduce_", group)]
        got = pc.verify_staged_program(
            program, num_workers=plan.num_workers, stacked_rows=rows,
            byte_budget=budget if sparse else None, context=name, group=group,
            layout=pc.layout_of(sharded))
        ref = jc.verify_staged_program(
            as_group_jaxpr(program, group), axis_name="model", stacked_rows=rows,
            byte_budget=budget if sparse else None, context=name)
        assert _all_key(got, port_line) == _all_key(ref, ref_line) == []
    # the free-worker schemes run on the world group, the fixed ones on a half
    assert (first["programs"][case][1] == other["programs"][case][1]) == (
        plan.num_workers == 8)


@pytest.mark.parametrize("probe", ["wrong-group", "no-collective"])
def test_collective_probes_are_flagged_like_the_reference(group_programs, probe):
    first, _, _ = group_programs
    program, group = first[probe]
    port_line, ref_line = _anchors()
    got = pc.verify_staged_program(program, num_workers=4, stacked_rows=None,
                                   byte_budget=None, context=probe, group=group)
    ref = jc.verify_staged_program(as_group_jaxpr(program, group), axis_name="model",
                                   stacked_rows=None, byte_budget=None, context=probe)
    assert _all_key(got, port_line) == _all_key(ref, ref_line) == [("collective-axis", "error")]
    # and the one-process rule has nothing to say about a rank's program
    assert "worker-combine" not in {f.rule for f in got}


def test_a_blind_collective_detector_fails_the_ranks(group_programs):
    for rank in group_programs[:2]:
        assert "collective-axis detector has lost sensitivity" in rank["blind"]
        run = rank["blind_run"]
        assert run["programs"] == 0 and run["launches"] == {}
        assert [(f.rule, f.severity) for f in run["findings"]] == [("collective-axis", "error")]
        assert "lost sensitivity" in run["findings"][0].message


def test_collective_axis_rule_counts_and_names():
    rec = lambda op, group: pc.OpRecord(f"c10d.{op}.default", op, (), (), group=group)  # noqa: E731
    one = [rec("allreduce_", "3")]
    assert pc.collective_axis_problems(one, group="3", layout="all_reduce") == []
    assert len(pc.collective_axis_problems(one, group="3", layout="reduce_scatter")) == 1
    assert len(pc.collective_axis_problems(one, group="0", layout="all_reduce")) == 1
    assert len(pc.collective_axis_problems(one * 2, group="3", layout="all_reduce")) == 1
    assert pc.collective_axis_problems([], group="3", layout="all_reduce") == [
        "no collective in the staged program: worker contributions are never combined"]
    assert pc.collective_axis_offenders(one + [rec("allreduce_", "0")], "3") == [
        ("allreduce_", "0")]
