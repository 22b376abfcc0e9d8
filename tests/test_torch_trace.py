"""The program's spans (``repro_torch.trace``) on the CPU.

A bound ``CodedOp`` under ``torch.profiler`` at the repo's test shapes (s =
32, r = 8m, t = 12n, bs = 8): one apply gives each span of the apply once
and one ``coded.worker`` a worker, nested on the profiler's clock; a rebind
gives one ``coded.rebind`` around one ``coded.decode_matrix``; the kernel
wrapper's index check gives one ``kernel.check_indices`` a call.  With no
profiler recording, ``span`` is one shared null context and
``record_function`` is never entered; a span changes no result.
"""

from __future__ import annotations

import json
import pathlib
import sys
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.coded import CodedMatmulConfig, plan  # noqa: E402
from repro_torch.kernels import spmm_block  # noqa: E402
from repro_torch.runtime import pack_cache  # noqa: E402
from repro_torch.sparse.blocksparse import dense_to_block_ell  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
S, BS, M, N_GROUPS, WORKERS = 32, 8, 2, 2, 8
#: the spans one apply enters once each, on either lane
ONCE = (trace.APPLY, trace.PACK_FOR, trace.RESOLVE_PACK, trace.DEVICE_PACK, trace.STAGE,
        trace.DECODE_WEIGHTS, trace.COMBINE)
NAMES = [v for k, v in vars(trace).items() if k.isupper() and isinstance(v, str)]
#: a worker mask with one dead worker, and a chunk mask with one worker's
#: second chunk missing; each decodes under the plan of ``_op``
DEAD = np.array([False] + [True] * (WORKERS - 1))
CHUNKS = np.ones((WORKERS, 2), dtype=bool)
CHUNKS[0, 1] = False


def _op():
    """A bound CPU op of the block-sparse backend, A at ~40% tile density."""
    rng = np.random.default_rng(7)
    r, t = 8 * M, 12 * N_GROUPS
    mask = rng.random((S // BS, r // BS)) < 0.4
    A = (rng.standard_normal((S, r)) * np.kron(mask, np.ones((BS, BS)))).astype(np.float32)
    B = rng.standard_normal((S, t)).astype(np.float32)
    cfg = CodedMatmulConfig(scheme="sparse_code", backend="block_sparse", block_size=BS)
    op = plan(cfg, m=M, n=N_GROUPS, num_workers=WORKERS, seed=0).bind("cpu")
    return op, torch.from_numpy(A), torch.from_numpy(B), dense_to_block_ell(A, BS)


def _spans(prof) -> Counter:
    return Counter(e.name for e in prof.events() if e.name in NAMES)


def _chip_spans():
    """The root's ``chip_spans.py``, which reads a traced run's spans."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_spans
    finally:
        sys.path.remove(str(ROOT))
    return chip_spans


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.mark.parametrize("survivors", [None, DEAD, CHUNKS], ids=["alive", "dead", "chunks"])
def test_one_apply_enters_each_span_once_and_one_worker_span_a_worker(survivors):
    op, A, B, ell = _op()
    op = op.with_survivors(survivors)
    op.apply(A, B, a_sparse=ell)  # the pack and its device copy are cached
    _, prof = _profiled(lambda: op.apply(A, B, a_sparse=ell))
    want = Counter({name: 1 for name in ONCE}) + Counter({trace.WORKER: WORKERS})
    assert _spans(prof) == want
    pack_cache.clear()


def test_the_chrome_trace_nests_workers_in_stage_in_apply(tmp_path):
    """The spans share the profiler's clock: each worker's span lies inside
    the stage's, the stage's and the pack's inside the apply's, by ``ts``
    and ``dur`` in the exported Chrome trace."""
    op, A, B, ell = _op()
    _, prof = _profiled(lambda: op.apply(A, B, a_sparse=ell))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    (apply_,), (stage,) = by[trace.APPLY], by[trace.STAGE]

    def inside(inner, outer):
        return outer[0] <= inner[0] and inner[1] <= outer[1]

    assert len(by[trace.WORKER]) == WORKERS
    assert all(inside(w, stage) for w in by[trace.WORKER])
    assert inside(stage, apply_)
    for name in (trace.PACK_FOR, trace.RESOLVE_PACK, trace.DEVICE_PACK):
        (one,) = by[name]
        assert inside(one, apply_) and one[1] <= stage[0]
    (combine,) = by[trace.COMBINE]
    assert inside(combine, stage) and max(w[1] for w in by[trace.WORKER]) <= combine[0]
    pack_cache.clear()


@pytest.mark.parametrize("survivors", [DEAD, CHUNKS], ids=["dead", "chunks"])
def test_a_rebind_gives_one_rebind_span_around_one_decode_matrix_span(survivors):
    op, *_ = _op()
    rebound, prof = _profiled(lambda: op.with_survivors(survivors))
    assert _spans(prof) == Counter({trace.REBIND: 1, trace.DECODE_MATRIX: 1})
    (outer,) = [e for e in prof.events() if e.name == trace.REBIND]
    (inner,) = [e for e in prof.events() if e.name == trace.DECODE_MATRIX]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert np.array_equal(rebound.plan_.decode, op.with_survivors(survivors).plan_.decode)


def test_restoring_the_base_plan_is_a_rebind_with_no_decode_matrix():
    op, *_ = _op()
    _, prof = _profiled(lambda: op.with_survivors(DEAD).with_survivors(None))
    assert _spans(prof) == Counter({trace.REBIND: 2, trace.DECODE_MATRIX: 1})


def test_each_index_check_is_one_span_and_each_slot_order_one():
    rng = np.random.default_rng(3)
    src = torch.from_numpy(np.stack([rng.integers(0, 4, (5, 6)), rng.integers(0, 2, (5, 6))],
                                    axis=-1).astype(np.int32))

    def calls():
        for _ in range(3):
            spmm_block._check_indices(src, 4, 2)
        spmm_block.slot_order(src, 4)

    _, prof = _profiled(calls)
    assert _spans(prof) == Counter({trace.CHECK_INDICES: 3, trace.SLOT_ORDER: 1})
    with pytest.raises(ValueError, match="src indices outside"):
        spmm_block._check_indices(src, 3, 2)


def test_with_no_profiler_span_is_the_shared_null_context(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span(trace.APPLY) is trace.span(trace.WORKER) is trace._OFF
    op, A, B, ell = _op()
    with trace.span(trace.APPLY):
        op.with_survivors(DEAD).apply(A, B, a_sparse=ell)
    pack_cache.clear()


@pytest.mark.parametrize("survivors", [None, DEAD], ids=["alive", "dead"])
def test_a_traced_apply_gives_the_untraced_result_bit_for_bit(survivors):
    op, A, B, ell = _op()
    op = op.with_survivors(survivors)
    plain = op.apply(A, B, a_sparse=ell)
    traced, _ = _profiled(lambda: op.apply(A, B, a_sparse=ell))
    assert torch.equal(plain, traced)
    pack_cache.clear()


def test_the_profiler_flag_the_helper_reads_exists_and_flips():
    """The private flag ``span`` reads: a torch that renames it fails here."""
    flag = torch.autograd.profiler._is_profiler_enabled
    assert flag is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert trace.span(trace.APPLY) is not trace._OFF
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_every_span_name_is_in_the_module_docstring_once():
    doc = trace.__doc__
    assert len(NAMES) == len(set(NAMES)) == 12
    for name in NAMES:
        assert doc.count(f" {name} ") == 1, name


def test_the_chip_script_counts_spans_per_apply_from_a_chrome_trace(tmp_path):
    """``chip_spans.summarize``: counts and host ms per apply of each span
    inside the harness's window, from a CPU run's exported trace."""
    chip_spans = _chip_spans()
    op, A, B, ell = _op()
    rebound = op.with_survivors(DEAD)
    rebound.apply(A, B, a_sparse=ell)
    rf = torch.autograd.profiler.record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rf(chip_spans.WINDOW_SPAN):
            for _ in range(3):
                with rf("rebind"):
                    this = op.with_survivors(DEAD)
                with rf("apply"):
                    this.apply(A, B, a_sparse=ell)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    got = chip_spans.summarize(json.loads(path.read_text())["traceEvents"])
    assert got["applies"] == 3
    per = {name: v["per_apply"] for name, v in got["spans"].items()}
    assert per == {**{name: 1.0 for name in ONCE}, trace.WORKER: float(WORKERS),
                   trace.REBIND: 1.0, trace.DECODE_MATRIX: 1.0, "apply": 1.0, "rebind": 1.0}
    for v in got["spans"].values():
        assert v["host_ms_per_apply"] > 0
    assert got["spans"][trace.STAGE]["host_ms_per_apply"] <= \
        got["spans"][trace.APPLY]["host_ms_per_apply"]
    # no device operation on the CPU: the whole window is idle
    for by in (got["idle"], got["idle_by_op"]):
        assert sum(by.values()) == pytest.approx(got["window_ms_per_apply"])
    assert got["idle"][trace.WORKER] > 0 and got["idle"]["outside"] > 0
    pack_cache.clear()


def test_the_chip_script_splits_an_idle_gap_by_program_span_and_host_operation():
    chip_spans = _chip_spans()

    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [x(chip_spans.WINDOW_SPAN, "user_annotation", 0, 1000),
              x("apply", "user_annotation", 100, 800),
              x(trace.APPLY, "user_annotation", 110, 780),
              x(trace.WORKER, "user_annotation", 200, 200),
              x("cudaMemcpyAsync", "cuda_runtime", 250, 10),
              x("spmm", "kernel", 0, 240), x("spmm", "kernel", 270, 680)]
    got = chip_spans.summarize(events)
    assert got["applies"] == 1 and got["window_ms_per_apply"] == pytest.approx(1.0)
    # the gap 240-270 us: 20 us in the worker's own code, 10 in its copy;
    # 950-1000 us: no program span open, and no host operation after 900
    assert got["idle"] == pytest.approx({trace.WORKER: 0.03, "outside": 0.05})
    assert got["idle_by_op"] == pytest.approx(
        {trace.WORKER: 0.02, f"{trace.WORKER}/cudaMemcpyAsync": 0.01,
         "outside/host idle": 0.05})
    assert got["spans"][trace.WORKER] == {"per_apply": 1.0, "host_ms_per_apply": 0.2}
