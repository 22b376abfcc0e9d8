"""CPU tests that drive whole runs of each cell at a small size, with the
search for a card skipped (the port's CPU lane): a sound run reads as
correct, and each fault planted under the timed path, and the control put
in the program's place, reads as not correct."""

from __future__ import annotations

import pytest

from portbench import control, faults, harness
from portbench.test_portbench_units import BENCH, SMALL

WORKLOADS = [w["name"] for w in BENCH["workloads"]]
SECONDS = 0.3


def small_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    cell.config.update(SMALL)
    return cell


def run(name: str, trace: bool = False, fault: str | None = None, seed: int = 2**31 + 7):
    return harness.run(small_cell(name), seed, SECONDS, trace, device="cpu", fault=fault)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_sound_run_is_correct_and_reports_its_cell(workload):
    loaded = set(harness.forbidden_modules())  # other tests of this process may
    result, work, lines = run(workload)
    cell = small_cell(workload)
    assert result["correct"] is True
    assert list(result)[-1] == "checks" and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert result["attempted"] == work["applies"] > 0
    assert all(m["value"] > 0 for k, m in result["metrics"].items() if k != "peak_device_gib")
    assert result["device"]["count"] == cell.chips
    cfg = cell.config
    assert work["degrees"] == [sum(1 for w in row if w) for row in cfg["coefficients"]]
    assert work["code"]["num_workers"] == len(cfg["coefficients"])
    assert 0 < work["live_tiles"] <= cfg["nnz_a"]
    assert work["live_slots"] > 0
    checked = work["patterns_checked"]
    assert 1 <= len(checked) <= 2 + harness.MORE_CHECKED
    assert all(d in work["patterns"] for d in checked)
    dead = cell.mix["dead_per_apply"]
    assert set(result["checks"]) == {"rel_err_dead" if dead else "rel_err_alive"}
    assert lines == [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
                     for k, c in result["checks"].items()]
    assert set(work["forbidden_modules"]) <= loaded  # the run loads none of them


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_traced_run_reads_its_per_layer_metrics(workload):
    result, _, _ = run(workload, trace=True)
    assert result["correct"] is True
    # the CPU has no device trace: only host readings are there
    want = {"rebind_ms"} if small_cell(workload).mix["dead_per_apply"] else set()
    assert set(result["metrics"]) == want
    assert result["device"]["window_s"] > 0 and "breakdown" in result


@pytest.mark.parametrize("workload,fault", [(w, f) for w in WORKLOADS for f in faults.FAULTS])
def test_a_broken_timed_path_reads_as_not_correct(workload, fault):
    """Each fault, and the control in the program's place, fails a limit of
    the cell's own check: the control's products at TF32 precision fail
    the limit of the answers with every worker alive or of those with dead
    workers, whichever the mix has."""
    from repro_torch.coded.op import CodedOp
    from repro_torch.kernels import ops

    sound = ops.spmm_block_fused_decode, CodedOp.apply
    result, _, _ = run(workload, fault=fault)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
    assert (ops.spmm_block_fused_decode, CodedOp.apply) == sound  # gone after the run


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_the_control_fails_the_limit(name):
    cell = small_cell(next(w for w in WORKLOADS if w.startswith(name + ".")))
    readings = [control.control_reading(cell.config, seed, "cpu") for seed in (1, 2, 3)]
    assert min(readings) > max(cell.config["limits"].values()), readings

