"""The port's launch tooling against the JAX package's, on the CPU.

All of it held exactly (``==``):

* ``Model.shapes`` and ``Model.specs`` of all 10 registered configs at full
  width, and
  ``input_specs`` for each kind;
* ``Model.cache_specs`` of every ``reduced()`` config on both meshes;
* the dry run's cells -- 6 families x {tiny_train, tiny_decode, tiny_decode
  with ``opt_serving_layout``} x the meshes {data 4, model 2} and {pod 2,
  data 2, model 2} of the JAX package's own small dry-run test: each
  argument leaf's sanitised placement and per-device shard shape, and
  ``argument_bytes`` as the sum of those shards' bytes;
* ``analytic_memory_bytes``, ``_recurrence_flops`` and ``cell_supported``
  for every config x every ``SHAPES`` entry;
* ``fused_kernel_cost`` and ``roofline_fraction`` over a grid;
* the report's three tables on the same records.

The reference's launch modules set ``XLA_FLAGS`` when imported, so its
values come from one subprocess (8 host devices; nothing is lowered or
compiled: shard shapes are read from the in-shardings), never from this
process.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, meshctx, report, roofline  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.training.data import input_specs  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

FAMILIES = ["internlm2-1.8b", "qwen3-moe-30b-a3b", "rwkv6-3b",
            "jamba-1.5-large-398b", "whisper-medium", "llama-3.2-vision-11b"]
MESHES = {"single": {"data": 4, "model": 2}, "multi": {"pod": 2, "data": 2, "model": 2}}
TINY_SHAPES = {"tiny_train": dict(seq=32, batch=8, kind="train"),
               "tiny_decode": dict(seq=32, batch=8, kind="decode")}
CELLS = [(a, s, serve, m) for a in FAMILIES for s, serve in
         (("tiny_train", False), ("tiny_decode", False), ("tiny_decode", True))
         for m in MESHES]
INPUT_BATCH, INPUT_SEQ = 2, 16

# the fused_kernel_cost grid
KERNEL_GRID = list(itertools.product(
    (0, 1, 7, 4096, 419_430), (8, 16), (1, 128, 4096), (1, 4), (8, 8192),
    (True, False), (1, 2, 4)))
PEAKS = [{"peak_flops": 989e12, "peak_bw": 3.35e12},
         {"peak_flops": 7.1e11, "peak_bw": 1.23e10}]
MEASURED_S = (1e-13, 1e-3, 8.554e-3)

_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")
from repro.launch import dryrun, report, roofline   # these set XLA_FLAGS
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import repro.configs as configs
from repro import compat
from repro.launch import meshctx
from repro.models import build
from repro.training.data import input_specs
from jax.sharding import PartitionSpec

spec_in = json.loads(open(sys.argv[1]).read())
out = {}

def key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)

def js(x):
    return [js(e) for e in x] if isinstance(x, (tuple, PartitionSpec)) else x

def flat(tree, fn, is_leaf=None):
    return {key(p): fn(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)}

def is_spec(x):
    return isinstance(x, tuple)

archs = sorted(configs.ARCHS)
out["archs"] = archs
out["shapes"], out["specs"], out["inputs"] = {}, {}, {}
for a in archs:
    m = build(configs.get(a))
    out["shapes"][a] = flat(m.shapes(), lambda s: [list(s.shape), str(s.dtype)])
    out["specs"][a] = flat(m.specs(), js, is_spec)
    for kind in ("train", "prefill", "decode"):
        out["inputs"][a + "/" + kind] = flat(
            input_specs(configs.get(a), spec_in["batch"], spec_in["seq"], kind=kind),
            lambda s: [list(s.shape), str(s.dtype)])

meshes = {}
for name, axes in spec_in["meshes"].items():
    meshes[name] = compat.make_mesh(tuple(axes.values()), tuple(axes),
                                    axis_types=compat.auto_axis_types(len(axes)))

out["cache_specs"] = {}
for a in archs:
    cfg = configs.get(a).reduced()
    m = build(cfg)
    cache = jax.eval_shape(lambda: m.init_cache(spec_in["batch"], spec_in["seq"]))
    for name, mesh in meshes.items():
        with meshctx.use_mesh(mesh):
            out["cache_specs"][a + "/" + name] = flat(
                m.cache_specs(cache), js, lambda x: isinstance(x, PartitionSpec))

def tiny(cfg):
    g = cfg.group_size
    kw = dict(num_layers=g, d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16, d_ff=128, vocab_size=512, max_seq=64)
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4, top_k=2, d_ff=32)
    if cfg.encoder_layers:
        kw["encoder_layers"] = 1
        kw["encoder_seq"] = 16
    if cfg.cross_attn_every:
        kw["vision_tokens"] = 16
    if cfg.rwkv:
        kw["rwkv_head_size"] = 16
    return dataclasses.replace(cfg, **kw)

dryrun.SHAPES.update(spec_in["tiny_shapes"])
out["cells"] = {}
for a, shp, serve, mname in spec_in["cells"]:
    cfg = tiny(configs.get(a))
    if serve:
        cfg = cfg.with_opts(("serving_layout",))
    mesh = meshes[mname]
    with meshctx.use_mesh(mesh):
        fn, args, in_sh, out_sh = dryrun.build_cell(cfg, shp, mesh)
    leaves = {}
    for i, (arg, sh) in enumerate(zip(args, in_sh)):
        both = jax.tree.map(lambda s, h: (s, h), arg, sh)
        for k, (s, h) in flat(both, lambda v: v,
                              lambda x: isinstance(x, tuple) and len(x) == 2 and
                              hasattr(x[1], "spec")).items():
            leaves[f"{i}/{k}"] = {"shard": list(h.shard_shape(s.shape)),
                                  "spec": js(tuple(h.spec)),
                                  "itemsize": s.dtype.itemsize}
    out["cells"][f"{a}/{shp}/{serve}/{mname}"] = leaves

out["memory"], out["recurrence"], out["supported"] = {}, {}, {}
for a in archs:
    cfg = configs.get(a)
    for shp, info in roofline.SHAPES.items():
        if shp.startswith("tiny"):
            continue
        k = a + "/" + shp
        out["memory"][k] = roofline.analytic_memory_bytes(cfg, shp)
        out["recurrence"][k] = roofline._recurrence_flops(cfg, info["batch"] * info["seq"])
        out["supported"][k] = list(dryrun.cell_supported(cfg, shp))

out["kernel_cost"] = [roofline.fused_kernel_cost(
    live_tiles=l, bs=bs, bt=bt, mn=mn, br=br, fused=f, tile_itemsize=it)
    for l, bs, bt, mn, br, f, it in spec_in["kernel_grid"]]
out["fraction"] = [[[roofline.roofline_fraction(c, s, p) for p in spec_in["peaks"]]
                    for s in spec_in["measured_s"]] for c in out["kernel_cost"]]

rec = spec_in["records"]
out["report"] = {
    "dryrun": report.dryrun_table(rec + "/dryrun"),
    "roofline": report.roofline_table(root=rec + "/roofline"),
    "roofline_all": report.roofline_table(include_variants=True, root=rec + "/roofline"),
    "perf": report.perf_table(rec + "/roofline")}
open(sys.argv[2], "w").write(json.dumps(out))
"""


def _report_records() -> dict:
    """Records shaped as the JAX package's dry run and roofline write them."""
    ok = {"arch": "internlm2-1.8b", "shape": "train_4k", "mesh": "single",
          "mesh_shape": {"data": 16, "model": 16}, "status": "ok", "lower_s": 3.1,
          "compile_s": 41.27,
          "cost_analysis": {"flops_per_device": 6.558e13, "bytes_per_device": 1.234e12,
                            "transcendentals": 1.5e9},
          "memory_analysis": {"argument_bytes": 297422852, "output_bytes": 296898564,
                              "temp_bytes": 7_812_345_678, "alias_bytes": 0,
                              "peak_bytes_est": 8_406_667_094},
          "collectives": {"total_bytes": 2.5e10}}
    dry = {
        "a__ok": ok,
        "b__multi": {**ok, "mesh": "multi", "compile_s": 88.0},
        "c__skipped": {"arch": "qwen2-7b", "shape": "long_500k", "mesh": "single",
                       "status": "skipped",
                       "reason": "long_500k needs sub-quadratic attention (skip per spec)"},
        "d__error": {"arch": "dbrx-132b", "shape": "train_4k", "mesh": "multi",
                     "status": "error", "error": "ValueError: " + "x" * 80},
    }

    def roof(arch, shape, opts, compute, memory, coll, dom):
        return {"arch": arch, "shape": shape, "status": "ok", "chips": 256,
                "terms": {"compute_s": compute, "memory_s": memory, "collective_s": coll},
                "dominant": dom, "model_flops": 1.7e16, "hlo_flops_total": 2.31e16,
                "useful_ratio": 0.7359, "roofline_fraction_bound": 0.5123, "opts": opts}

    roofs = {
        "a": roof("internlm2-1.8b", "train_4k", [], 0.0663, 0.0827, 0.0312, "memory_s"),
        "b": roof("internlm2-1.8b", "train_4k", ["fused_ce"], 0.0612, 0.0705, 0.0312,
                  "memory_s"),
        "c": roof("internlm2-1.8b", "train_4k", ["fused_ce", "onehot_cache"], 0.06, 0.05,
                  0.09, "collective_s"),
        "d": roof("qwen3-moe-30b-a3b", "decode_32k", [], 4.9e-6, 4.85e-4, 1.2e-5,
                  "memory_s"),
        "e": {"arch": "dbrx-132b", "shape": "prefill_32k", "status": "error",
              "error": "RuntimeError: probe failed" * 4, "opts": []},
        "f": {"arch": "qwen2-7b", "shape": "long_500k", "status": "skipped",
              "reason": "long_500k needs sub-quadratic attention (skip per spec)"},
    }
    return {"dryrun": dry, "roofline": roofs}


def _write_records(root: pathlib.Path) -> None:
    for kind, recs in _report_records().items():
        (root / kind).mkdir(parents=True)
        for name, rec in recs.items():
            (root / kind / f"{name}.json").write_text(json.dumps(rec))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    _write_records(tmp / "records")
    spec_in = {"batch": INPUT_BATCH, "seq": INPUT_SEQ, "meshes": MESHES,
               "tiny_shapes": TINY_SHAPES, "cells": CELLS, "kernel_grid": KERNEL_GRID,
               "peaks": PEAKS, "measured_s": MEASURED_S, "records": str(tmp / "records")}
    (tmp / "in.json").write_text(json.dumps(spec_in))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp / "in.json"),
                           str(tmp / "out.json")],
                          env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads((tmp / "out.json").read_text())
    out["records"] = tmp / "records"
    return out


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _js(x):
    return [_js(e) for e in x] if isinstance(x, tuple) else x


def _flat(tree, fn) -> dict:
    out = {}
    dryrun._map(lambda path, leaf: out.__setitem__(_key(path), fn(leaf)), tree)
    return out


def _tiny(cfg):
    g = cfg.group_size
    kw = dict(num_layers=g, d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16, d_ff=128, vocab_size=512, max_seq=64)
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4, top_k=2, d_ff=32)
    if cfg.encoder_layers:
        kw["encoder_layers"] = 1
        kw["encoder_seq"] = 16
    if cfg.cross_attn_every:
        kw["vision_tokens"] = 16
    if cfg.rwkv:
        kw["rwkv_head_size"] = 16
    return dataclasses.replace(cfg, **kw)


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


ARCHS = sorted(configs.ARCHS)


def test_the_same_configs(ref):
    assert ARCHS == ref["archs"] and len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_specs(ref, arch):
    model = build(configs.get(arch), "meta")
    shapes = model.shapes()
    assert all(t.device.type == "meta" for t in dryrun._leaves(shapes))
    assert _flat(shapes, lambda t: [list(t.shape), _dtype(t)]) == ref["shapes"][arch]
    assert _flat(model.specs(), _js) == ref["specs"][arch]
    assert _flat(model.shapes(torch.float32), _dtype) == {
        k: "float32" for k in ref["shapes"][arch]}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs(ref, arch):
    for kind in ("train", "prefill", "decode"):
        got = input_specs(configs.get(arch), INPUT_BATCH, INPUT_SEQ, kind=kind)
        assert _flat(got, lambda t: [list(t.shape), _dtype(t)]) == ref["inputs"][f"{arch}/{kind}"]
    with pytest.raises(ValueError):
        input_specs(configs.get(arch), 1, 1, kind="score")


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_on_both_meshes(ref, arch):
    model = build(configs.get(arch).reduced(), "meta")
    cache = model.init_cache(INPUT_BATCH, INPUT_SEQ)
    for name, mesh in MESHES.items():
        with meshctx.use_mesh(mesh):
            got = _flat(model.cache_specs(cache), _js)
        assert got == ref["cache_specs"][f"{arch}/{name}"], name
    # with no mesh every leaf is replicated
    assert all(v == [] for v in _flat(model.cache_specs(cache), _js).values())


@pytest.fixture
def tiny_shapes(monkeypatch):
    for name, info in TINY_SHAPES.items():
        monkeypatch.setitem(dryrun.SHAPES, name, info)


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(map(str, c)) for c in CELLS])
def test_cell_placements_shards_and_argument_bytes(ref, tiny_shapes, cell):
    """Each argument leaf's sanitised placement (``_sanitize``, and
    ``_serving_layout`` for the decode cells with ``opt_serving_layout``)
    and per-device shard shape, and ``argument_bytes``."""
    arch, shp, serve, mname = cell
    cfg = _tiny(configs.get(arch))
    if serve:
        cfg = cfg.with_opts(("serving_layout",))
    mesh = MESHES[mname]
    with meshctx.use_mesh(mesh):
        _, args, specs, _ = dryrun.build_cell(cfg, shp, mesh)
    got = {}
    for i, (tree, spec) in enumerate(zip(args, specs)):
        def leaf(path, a, s, i=i):
            got[f"{i}/{_key(path)}"] = {
                "shard": list(dryrun.shard_shape(dryrun._shape(a), s, mesh)),
                "spec": _js(s), "itemsize": dryrun._itemsize(a)}
        dryrun._map(leaf, tree, spec)
    want = ref["cells"][f"{arch}/{shp}/{serve}/{mname}"]
    assert got == want
    total = sum(math.prod(v["shard"]) * v["itemsize"] for v in want.values())
    assert sum(dryrun.argument_bytes(a, s, mesh) for a, s in zip(args, specs)) == total


@pytest.mark.parametrize("shp", ["tiny_train", "tiny_decode"])
def test_run_cell_records_the_argument_bytes(ref, tiny_shapes, shp):
    cfg = _tiny(configs.get("internlm2-1.8b"))
    for mname, mesh in MESHES.items():
        want = ref["cells"][f"internlm2-1.8b/{shp}/False/{mname}"]
        rec = dryrun.run_cell("internlm2-1.8b", shp, mname == "multi", cfg_override=cfg,
                              mesh=mesh)
        ma = rec["memory_analysis"]
        assert ma["argument_bytes"] == sum(math.prod(v["shard"]) * v["itemsize"]
                                           for v in want.values())
        assert ma["argument_bytes"] == sum(rec["argument_bytes_by_kind"].values())
        assert ma["peak_bytes_est"] == ma["argument_bytes"] + ma["temp_bytes"] > 0
        assert rec["cost_analysis"]["flops_per_device"] > 0
        coll = rec["collectives"]
        assert coll["total_bytes"] == sum(coll["bytes"].values()) > 0 and rec["depth"] == "full"


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_memory_recurrence_and_support(ref, arch):
    cfg = configs.get(arch)
    for shp, info in dryrun.SHAPES.items():
        k = f"{arch}/{shp}"
        assert roofline.analytic_memory_bytes(cfg, shp) == ref["memory"][k]
        assert roofline._recurrence_flops(cfg, info["batch"] * info["seq"]) == \
            ref["recurrence"][k]
        assert list(dryrun.cell_supported(cfg, shp)) == ref["supported"][k]


def test_kernel_cost_and_roofline_fraction(ref):
    for args, want, fractions in zip(KERNEL_GRID, ref["kernel_cost"], ref["fraction"],
                                     strict=True):
        l, bs, bt, mn, br, fused, item = args
        cost = roofline.fused_kernel_cost(live_tiles=l, bs=bs, bt=bt, mn=mn, br=br,
                                          fused=fused, tile_itemsize=item)
        assert cost == want
        assert [[roofline.roofline_fraction(cost, s, p) for p in PEAKS]
                for s in MEASURED_S] == fractions


@pytest.mark.parametrize("table", ["dryrun", "roofline", "roofline_all", "perf"])
def test_report_tables_render_as_the_reference(ref, table):
    recs = ref["records"]
    got = {"dryrun": lambda: report.dryrun_table(recs / "dryrun"),
           "roofline": lambda: report.roofline_table(root=recs / "roofline"),
           "roofline_all": lambda: report.roofline_table(True, recs / "roofline"),
           "perf": lambda: report.perf_table(recs / "roofline")}[table]()
    assert got == ref["report"][table]
