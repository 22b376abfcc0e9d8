"""CPU tests of the benchmark's own parts: cells found by name, the work
fixed by the configuration, the traffic cycle, the yardstick's counts, the
reference and its control, the trace reduction, and what the benchmark's
modules import.  None needs a card."""

from __future__ import annotations

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from portbench import harness, loadgen, operands, reference, tracing, yardstick

HERE = pathlib.Path(__file__).resolve().parent
BENCH = json.loads(harness.BENCH_FILE.read_text())
CONFIGS = [c["name"] for c in BENCH["configs"]]
#: sizes of the configurations' shapes that a test can hold: 4 nonzeros a
#: row and a column on average, as at full size
SMALL = {"s": 256, "r": 256, "t": 256, "nnz_a": 1024, "nnz_b": 1024}


def config(name: str, sizes: dict | None = None) -> dict:
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    return json.loads((harness.ROOT / entry["file"]).read_text()) | (sizes or {})


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cells_metrics_and_mixes_found_by_name(workload):
    cell = harness.load_cell(workload, bench=BENCH)
    entry = {w["name"]: w for w in BENCH["workloads"]}[workload]
    assert cell.config["name"] == entry["config"]
    assert cell.chips == entry["chips"] == cell.config["chips"]
    assert cell.mix == loadgen.load_mix(entry["traffic"])
    assert {m["name"] for m in cell.end_to_end} == {m["name"] for m in BENCH["end_to_end"]}
    listed = {m["name"] for m in BENCH["per_layer"] if workload in m["workloads"]}
    assert {m["name"] for m in cell.per_layer} == listed and listed
    for m in cell.per_layer:
        assert harness.load_reader(m["name"]).UNIT == m["unit"]


def test_every_reader_and_file_is_named_by_the_benchmark():
    """Every file of the folder serves a cell of BENCHMARK.json, and every
    per-layer entry names the cells that report it."""
    readers = {p.stem for p in (HERE / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in BENCH["per_layer"]}
    assert {p.stem for p in (HERE / "traffic").glob("*.json")} == {
        w["traffic"] for w in BENCH["workloads"]}
    assert sorted(str(p.relative_to(harness.ROOT)) for p in (HERE / "configs").glob("*")) \
        == sorted(c["file"] for c in BENCH["configs"])
    with pytest.raises(KeyError, match="no workload"):
        harness.load_cell("no-such.cell")
    with pytest.raises(FileNotFoundError, match="no reader"):
        harness.load_reader("no_such_metric")
    unlisted = BENCH | {"per_layer": [{k: v for k, v in m.items() if k != "workloads"}
                                      for m in BENCH["per_layer"]]}
    with pytest.raises(KeyError, match="workloads"):
        harness.load_cell(BENCH["workloads"][0]["name"], bench=unlisted)


@pytest.mark.parametrize("name", CONFIGS)
def test_work_is_fixed_by_the_configuration_not_the_seed(name):
    """The port's plan for code_seed is the file's code, and seeds 0-11
    give the same code, exactly nnz nonzeros in A and in B, and live slots
    within a few tenths of a percent of each other (tiles that two
    nonzeros share), with different values of A and B."""
    from repro_torch.coded import registry

    cfg = config(name, {"s": 2048, "r": 2048, "t": 2048, "nnz_a": 8192, "nnz_b": 8192})
    p = registry.get_scheme(cfg["scheme"]).plan(cfg["m"], cfg["n"], cfg["num_workers"],
                                                seed=cfg["code_seed"])
    np.testing.assert_array_equal(p.coefficient_matrix(), cfg["coefficients"])
    s, r, t, bs = operands.geometry(cfg)
    geo = (s, r, t, bs, cfg["m"], cfg["n"])
    slots, prints = [], []
    for seed in range(12):
        ops = operands.draw(cfg, seed, "cpu")
        assert int(ops.A.count_nonzero()) == cfg["nnz_a"]
        assert int(ops.B.count_nonzero()) == cfg["nnz_b"]
        live = yardstick.live_mask(ops.rows.numpy(), ops.nnzb.numpy(), s, bs)
        assert int(live.sum()) == ops.live_tiles
        slots.append(sum(w["slots"] for w in yardstick.launch_work(cfg["coefficients"], geo,
                                                                     live)))
        prints.append((float(ops.A.sum()), float(ops.B.sum())))
    assert max(slots) / min(slots) < 1.01
    assert len(set(prints)) == 12


def test_block_ell_is_a_with_its_live_tiles_in_order():
    cfg = config(CONFIGS[0], SMALL)
    s, r, _, bs = operands.geometry(cfg)
    ops = operands.draw(cfg, 2**31 + 11, "cpu")
    ell = operands.block_ell(ops, cfg)
    A = ops.A.numpy()
    tiles = A.reshape(s // bs, bs, r // bs, bs).transpose(2, 0, 1, 3)   # (CB, RB, bs, bs)
    for cb in range(r // bs):
        k = int(ell.nnzb[cb])
        rows = ell.idx[cb, :k]
        np.testing.assert_array_equal(rows, np.flatnonzero(np.abs(tiles[cb]).sum(axis=(1, 2))))
        np.testing.assert_array_equal(ell.vals[cb, :k], tiles[cb, rows])
        assert not ell.vals[cb, k:].any() and not ell.idx[cb, k:].any()
    from repro_torch.sparse.blocksparse import dense_to_block_ell

    want = dense_to_block_ell(A, block_size=bs)
    np.testing.assert_array_equal(ell.nnzb, want.nnzb)


def test_stragglers_lose_every_worker_once_a_cycle():
    mix = loadgen.load_mix("stragglers")
    M = np.asarray(config(CONFIGS[0])["coefficients"], dtype=float)
    N, k = M.shape[0], mix["dead_per_apply"]
    cycles = [loadgen.cycle(mix, M, seed) for seed in range(12)]
    for cyc in cycles:
        assert len(cyc) == N // k and all(len(dead) == k for dead in cyc)
        assert sorted(w for dead in cyc for w in dead) == list(range(N))
        for dead in cyc:
            assert loadgen.decodable(M, loadgen.survivors(dead, N))
    assert len({tuple(c) for c in cycles}) == 12
    assert cycles[3] == loadgen.cycle(mix, M, 3)
    assert loadgen.cycle(loadgen.load_mix("steady"), M, 5) == [()]
    assert loadgen.survivors((), N) is None
    # a code that no deal can decode is refused
    with pytest.raises(ValueError, match="no deal"):
        loadgen.cycle(mix, np.eye(4), 0)


def _brute_force(M, geo, A_live):
    """Each worker's (slots, FLOPs, bytes) by walking every tile."""
    s, r, t, bs, m, n = geo
    br, bt = r // m, t // n
    RB, CBl = s // bs, br // bs
    out = []
    for row in M:
        slots, a_tiles, b_tiles = 0, set(), set()
        for c in np.flatnonzero(row):
            i, j = divmod(int(c), n)
            for cb in range(CBl):
                for rb in range(RB):
                    if A_live[rb, i * CBl + cb]:
                        slots += 1
                        a_tiles.add((rb, i * CBl + cb))
                        b_tiles.add((rb, j))
        nbytes = 4 * (len(a_tiles) * bs * bs + len(b_tiles) * bs * bt + m * n * br * bt)
        out.append({"slots": slots, "flops": 2 * bs * bs * bt * slots, "bytes": nbytes})
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_roofline_counts_match_a_brute_force_count(name):
    cfg = config(name, {"s": 64, "r": 64, "t": 64, "nnz_a": 96, "nnz_b": 96})
    s, r, t, bs = operands.geometry(cfg)
    geo = (s, r, t, bs, cfg["m"], cfg["n"])
    ops = operands.draw(cfg, 2**31 + 3, "cpu")
    A = ops.A.numpy()
    A_live = np.abs(A.reshape(s // bs, bs, r // bs, bs)).sum(axis=(1, 3)) > 0
    live = yardstick.live_mask(ops.rows.numpy(), ops.nnzb.numpy(), s, bs)
    np.testing.assert_array_equal(live, A_live)
    work = yardstick.launch_work(cfg["coefficients"], geo, live)
    assert work == _brute_force(np.asarray(cfg["coefficients"]), geo, A_live)
    peaks = yardstick.PEAKS["NVIDIA H100 80GB HBM3"]
    dead = (1, 5)
    assert yardstick.apply_bound_s(work, dead, peaks) == pytest.approx(
        sum(max(w["flops"] / 67e12, w["bytes"] / 3.35e12)
            for k, w in enumerate(work) if k not in dead))


def test_reference_and_control_against_numpy():
    gen = torch.Generator().manual_seed(4)
    A = torch.randn(96, 40, generator=gen)
    B = torch.randn(96, 24, generator=gen)
    want = A.double().numpy().T @ B.double().numpy()
    got = reference.product(A, B).double().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6
    # TF32: the sign, the exponent and 10 mantissa bits, rounded to nearest
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0 - 2**-10, 1.0 + 2**-12])
    np.testing.assert_array_equal(reference.round_tf32(x).numpy(),
                                  [1.0 + 2**-10, 1.0 + 2**-10, -3.0 - 2**-9, 1.0])
    r = reference.round_tf32(A).view(torch.int32)
    assert int((r & ((1 << 13) - 1)).abs().max()) == 0
    ctl = reference.rel_err(reference.control_product(A, B), reference.product(A, B))
    assert 1e-5 < ctl < 1e-2
    assert reference.rel_err(torch.full((40, 24), float("nan")), torch.ones(40, 24)) \
        == float("inf")
    assert reference.rel_err(torch.ones(2, 2), torch.ones(3, 2)) == float("inf")


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reduction_clips_to_the_window_and_names_idle_gaps():
    events = [
        _x(tracing.WINDOW_SPAN, "user_annotation", 100, 1000),
        _x(tracing.WINDOW_SPAN, "gpu_user_annotation", 90, 1020),
        _x("apply", "user_annotation", 110, 880),
        _x("aten::sort", "cpu_op", 300, 150),
        _x("cudaStreamSynchronize", "cuda_runtime", 320, 20),
        _x("spmm_block_fused_kernel<8>", "kernel", 50, 100),      # starts before
        _x("spmm_block_fused_kernel<8>", "kernel", 140, 100),     # overlaps the next
        _x("reduce_kernel", "kernel", 200, 100),
        _x("Memcpy DtoD", "gpu_memcpy", 500, 100),
        _x("sum", "kernel", 1000, 50),
        _x("late", "kernel", 1200, 10),                          # after the window
    ]
    tr = tracing.reduce(events)
    assert tr.window_s == pytest.approx(1000e-6)
    assert [op[0] for op in tr.device_ops] == ["spmm_block_fused_kernel<8>"] * 2 + [
        "reduce_kernel", "Memcpy DtoD", "sum"]
    # busy: [100, 300), [500, 600) and [1000, 1050)
    assert tr.busy_s == pytest.approx(350e-6)
    # each gap under the span and the innermost host operation at its middle
    assert dict(tr.idle_gaps) == pytest.approx(
        {"apply/aten::sort": 200e-6, "apply": 400e-6, "host idle": 50e-6})
    assert tr.top_ops()[0] == ["spmm_block_fused_kernel<8>", pytest.approx(200e-6)]
    assert tracing.reduce(events[2:]) is None


def test_readers_leave_out_what_they_cannot_read():
    empty = harness.Readings(applies=10, window_s=1.0, trace=None, spmm_bound_s=None,
                             rebind_s=None)
    for m in BENCH["per_layer"]:
        assert harness.load_reader(m["name"]).read(empty) is None, m["name"]
    idle = tracing.DeviceTrace(window_s=1.0, device_ops=[], busy_s=0.0, idle_gaps=[])
    nothing = harness.Readings(applies=10, window_s=1.0, trace=idle, spmm_bound_s=1.0,
                               rebind_s=None)
    for m in BENCH["per_layer"]:
        assert harness.load_reader(m["name"]).read(nothing) is None, m["name"]
    ops = [("spmm_block_fused_kernel", "kernel", 0.0, 2000.0),
           ("sort", "kernel", 0.0, 500.0), ("Memcpy", "gpu_memcpy", 0.0, 500.0)]
    busy = tracing.DeviceTrace(window_s=0.01, device_ops=ops, busy_s=0.004, idle_gaps=[])
    got = harness.Readings(applies=2, window_s=0.01, trace=busy, spmm_bound_s=0.0005,
                           rebind_s=0.002)
    read = {m["name"]: harness.load_reader(m["name"]).read(got) for m in BENCH["per_layer"]}
    assert read == pytest.approx({"spmm_ms": 1.0, "spmm_roofline": 25.0,
                                  "stage_other_ms": 0.5, "kernels_per_apply": 1.0,
                                  "rebind_ms": 1.0, "device_idle_share": 60.0})


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops)
    # the yardstick, the reference, the traffic and the readers take
    # nothing from the program
    for path in [HERE / "reference.py", HERE / "yardstick.py", HERE / "loadgen.py",
                 HERE / "tracing.py", *sorted((HERE / "metrics").glob("*.py"))]:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "repro_torch" not in tops, path


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(["reprox", "repro_torch.coded", "jaxtyping", "numpy"]) \
        == []
    assert harness.forbidden_modules(["repro.core", "jax", "jaxlib.xla", "flax"]) \
        == ["flax", "jax", "jaxlib", "repro"]
