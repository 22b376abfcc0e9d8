"""The port's launch tooling on its own, on the CPU.

* ``machine_peaks``: the H100 data sheet when asked, calibrated (and
  named so) on the CPU, and no silent CPU run without a card;
* the meshes as axis-size dicts, ``meshctx.spec``'s "dp" alias;
* the model is built on meta for the dry run while ``resolve_device``
  still refuses meta;
* ``LiveBytes`` counts what operations allocate while it lives, not views,
  in-place results or the arguments;
* the 1- and 2-group probes, combined, give the full-depth FLOP count
  exactly (integer FLOPs; structurally identical groups), the encoder's
  marginal layer included;
* ``python -m repro_torch.launch.{dryrun,roofline,report}`` in
  subprocesses write records and render them, with ``—`` where a port
  record has no value.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core.blocks import resolve_device  # noqa: E402
from repro_torch.launch import dryrun, mesh, meshctx, report, roofline  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_machine_peaks_sheet_and_cpu_calibration():
    sheet = roofline.machine_peaks(calibrate=False)
    assert sheet == {"peak_flops": 989e12, "peak_bw": 3.35e12,
                     "source": "datasheet-h100-sxm"}
    cpu = roofline.machine_peaks(device="cpu", reps=2)
    assert cpu["source"] == "calibrated on cpu (host clock)"
    assert cpu["peak_flops"] > 0 and cpu["peak_bw"] > 0
    assert roofline.machine_peaks(True, device="cpu", reps=1)["source"] == cpu["source"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            roofline.machine_peaks()


def test_meshes_and_spec():
    assert mesh.make_production_mesh() == {"data": 16, "model": 16}
    assert list(mesh.make_production_mesh(multi_pod=True)) == ["pod", "data", "model"]
    assert mesh.mesh_devices(mesh.make_production_mesh(multi_pod=True)) == 512
    assert mesh.make_mesh_for_devices(8) == {"data": 1, "model": 8}
    assert mesh.make_mesh_for_devices(48) == {"data": 3, "model": 16}
    with pytest.raises(ValueError, match="not divisible"):
        mesh.make_mesh_for_devices(20)
    assert mesh.ICI_BW is None
    assert meshctx.spec("dp", "model") == () and meshctx.get_mesh() is None
    with meshctx.use_mesh({"data": 4, "model": 2}):
        assert meshctx.spec("dp", None, "model", ("pod", "model")) == \
            ("data", None, "model", ("model",))
        with meshctx.use_mesh({"pod": 2, "data": 2, "model": 2}):
            assert meshctx.spec("dp", "pod") == (("pod", "data"), "pod")
        assert meshctx.spec("pod") == (None,)
    assert meshctx.get_mesh() is None


def test_meta_build_leaves_the_device_rule_alone():
    model = build(configs.get("internlm2-1.8b").reduced(), "meta")
    assert model.device == torch.device("meta")
    with pytest.raises(ValueError, match="neither a CUDA device nor the CPU"):
        resolve_device("meta")


def test_live_bytes_counts_allocations_while_they_live():
    a = torch.zeros(1000)                  # an argument: made before the mode
    with dryrun.LiveBytes() as live:
        b = a + 1                          # 4000 B
        a.add_(1)                          # in place: nothing
        v = b[10:]                         # a view: nothing
        c = torch.cat([b, b])              # 8000 B
        assert (live.live, live.peak) == (12000, 12000)
        del b
        assert live.live == 12000          # the view v keeps b's storage
        del v
        assert live.live == 8000
        del c
        assert live.live == 0
        d = torch.ones(10, dtype=torch.float64)
        assert live.live == 80 and live.peak == 12000 and live.owns(d)
    assert not live.owns(a)


PROBE_SHAPES = {"probe_train": dict(seq=8, batch=2, kind="train"),
                "probe_decode": dict(seq=8, batch=2, kind="decode")}


def _tiny(cfg, groups: int):
    kw = dict(num_layers=cfg.group_size * groups, d_model=32, num_heads=4, num_kv_heads=2,
              head_dim=8, d_ff=64, vocab_size=128, max_seq=64)
    if cfg.moe:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4, top_k=2, d_ff=16)
    if cfg.encoder_layers:
        kw["encoder_layers"] = 3
        kw["encoder_seq"] = 8
    if cfg.cross_attn_every:
        kw["vision_tokens"] = 8
    if cfg.rwkv:
        kw["rwkv_head_size"] = 8
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=4)
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-moe-30b-a3b", "rwkv6-3b",
                                  "jamba-1.5-large-398b", "whisper-medium",
                                  "llama-3.2-vision-11b"])
def test_probes_extrapolate_to_the_full_depth_flops(monkeypatch, arch):
    for name, info in PROBE_SHAPES.items():
        monkeypatch.setitem(dryrun.SHAPES, name, info)
    cfg = _tiny(configs.get(arch), 3)
    one = {"data": 1, "model": 1}
    for shp in PROBE_SHAPES:
        full = dryrun.run_cell(arch, shp, False, cfg_override=cfg, mesh=one, probes=False)
        probed = dryrun.run_cell(arch, shp, False, cfg_override=cfg, mesh=one, probes=True)
        assert full["depth"] == "full" and probed["depth"].startswith("probes")
        flops = full["cost_analysis"]["flops_per_device"]
        assert flops > 0 and flops == int(flops)
        assert probed["cost_analysis"]["flops_per_device"] == flops, shp
        assert probed["memory_analysis"]["argument_bytes"] == \
            full["memory_analysis"]["argument_bytes"]


def _run(*args, timeout=300):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-m", *args], env=env, capture_output=True,
                          text=True, timeout=timeout, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return proc.stdout


def test_dryrun_roofline_and_report_clis(tmp_path):
    out = _run("repro_torch.launch.dryrun", "--arch", "internlm2-1.8b", "--shape",
               "train_4k", "--out", str(tmp_path / "dryrun"))
    assert "failures" in out and "0 failures" in out
    recs = sorted((tmp_path / "dryrun").glob("*.json"))
    assert [p.name for p in recs] == ["internlm2-1.8b__train_4k__multi.json",
                                      "internlm2-1.8b__train_4k__single.json"]
    single = json.loads(recs[1].read_text())
    assert single["mesh_shape"] == {"data": 16, "model": 16}
    assert single["depth"] == "full" and single["collectives"] is None
    # the cache: a second run reads the records
    assert "cached" in _run("repro_torch.launch.dryrun", "--arch", "internlm2-1.8b",
                            "--shape", "train_4k", "--out", str(tmp_path / "dryrun"))

    out = _run("repro_torch.launch.roofline", "--arch", "internlm2-1.8b", "--shape",
               "decode_32k", "--out", str(tmp_path / "roofline"))
    assert "coll=—" in out and "dom=memory_s" in out

    table = _run("repro_torch.launch.report", "--dryrun", "--roofline",
                 "--root", str(tmp_path))
    rows = [r for r in table.splitlines() if r.startswith("| internlm2-1.8b")]
    assert len(rows) == 3, table
    assert rows[0].startswith("| internlm2-1.8b | train_4k | multi | ok |")
    assert rows[0].split(" | ").count("—") == 2 and "(meta)" in rows[0]
    assert rows[2].startswith("| internlm2-1.8b | decode_32k | baseline |")
    assert "| — | memory |" in rows[2]


def test_report_placeholder_without_records(tmp_path):
    table = report.dryrun_table(tmp_path / "none")
    assert "no dryrun records" in table and "repro_torch.launch.dryrun" in table
    assert report.roofline_table(root=tmp_path).count("\n") == 1
