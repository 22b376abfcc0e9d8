"""The dry run on a fake mesh: its collectives against a real group's, the
roofline's collective term, and the remat policy that saves the TP sums.

``launch.dryrun.run_cell`` runs a cell's step sharded as rank 0 of a fake
process group (``launch.mesh.fake_device_mesh``) and records the
collectives it issues (``meshctx.Collectives``).  One 4-rank gloo group on
``device="cpu"`` ({data 2, model 2}, one launch, a module fixture) runs the
same cells' steps for real, on arguments made on the CPU in the shards'
shapes and placed by the same specs (``dryrun.place``), under the same
capture.  Held:

* a reduced internlm2 train cell and a reduced whisper decode cell (its
  memory's k/v cached, sequence-sharded over "model"): the fake run's
  collectives equal rank 0's, kind by kind, counts and bytes, backward
  included (the fake mesh of gloo's device type, whose DTensor moves a
  shard to another dim by an all-gather as gloo's does);
* with no ``DeviceMesh`` the capture records nothing;
* ``fake_device_mesh`` refuses to start under a live group and leaves none;
* the roofline's collective bytes equal the JAX package's formula
  (``repro.launch.roofline._extract``, in a subprocess: the reference's
  launch modules pin ``XLA_FLAGS`` when imported) on the same record, and
  its ``collective_s`` is them over ``launch.mesh.ICI_BW``;
* ``opt_remat_save_tp``: a train cell issues fewer all-reduce bytes than
  plain remat (fake run and gloo run alike), with the same loss and
  gradients (gloo run, within RTOL / GRAD_RTOL);
* a model without RoPE adds the sinusoidal rows of its step's positions
  alone (``LiveBytes``: no (max_seq, d) table, which each step used to
  make, 671 MB with its temporaries at rwkv6-3b's width), so the rwkv6-3b
  decode cell's ``temp_bytes`` on the fake {data 2, model 2} mesh is below
  one such table.
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

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.launch import dryrun, meshctx, roofline  # noqa: E402
from repro_torch.launch.mesh import ICI_BW, fake_device_mesh  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.runtime import workergroup  # noqa: E402
from repro_torch.training.data import SyntheticCorpus, distribute_batch  # noqa: E402
from repro_torch.training.train_step import value_and_grad  # noqa: E402
from repro_torch.training.tree import tree_leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = {"data": 2, "model": 2}
RTOL, GRAD_RTOL = 1e-5, 1e-4
LAUNCH_TIMEOUT_S = 240.0
SHAPES = {"mesh_train": dict(seq=16, batch=4, kind="train"),
          "mesh_decode": dict(seq=32, batch=4, kind="decode"),
          # the roofline's production mesh: 16 dp shards of the batch
          "mesh_roofline": dict(seq=8, batch=16, kind="train")}
# (arch, shape, opts): the cells run both ways
CELLS = {"lm_train": ("internlm2-1.8b", "mesh_train", ()),
         "lm_train_save_tp": ("internlm2-1.8b", "mesh_train", ("remat_save_tp",)),
         "whisper_decode": ("whisper-medium", "mesh_decode", ())}


def _cfg(arch: str, opts=()):
    cfg = tcfg.get(arch).reduced()
    return cfg.with_opts(opts) if opts else cfg


def _local(shape, leaf, _path):
    """A real local shard in the leaf's dtype: token ids below every
    reduced vocab, positive values elsewhere (the optimizer's v is square
    rooted).  The collectives depend on shapes only."""
    gen = torch.Generator().manual_seed(len(shape) * 7 + sum(shape))
    if not leaf.dtype.is_floating_point:
        return torch.randint(0, 500, shape, generator=gen, dtype=leaf.dtype)
    return (torch.rand(shape, generator=gen) * 0.02).to(leaf.dtype)


def _real_cell(device, dmesh, name: str) -> dict:
    arch, shape, opts = CELLS[name]
    mesh = meshctx.mesh_shape(dmesh)
    with meshctx.use_mesh(mesh):
        fn, args, specs, _ = dryrun.build_cell(_cfg(arch, opts), shape, mesh, device=device)
    with meshctx.use_mesh(dmesh):
        placed = dryrun.place(args, specs, dmesh, make=_local)
        with meshctx.Collectives() as coll:
            fn(*placed)
    return coll.summary()


def _numpy(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().float().cpu().numpy()


def _remat_rank(device, dmesh) -> dict:
    """The reduced internlm2's loss and gradients with plain remat and with
    ``opt_remat_save_tp``, each with its all-reduce bytes."""
    out = {}
    for opts in ((), ("remat_save_tp",)):
        model = tbuild(_cfg("internlm2-1.8b", opts), device)
        batch = SyntheticCorpus(model.cfg, 4, 16, seed=0).make_batch(0)
        with meshctx.use_mesh(dmesh):
            params = meshctx.distribute(model.init(0), model.specs(), dmesh)
            with meshctx.Collectives() as coll:
                loss, grads = value_and_grad(model, params, distribute_batch(batch, dmesh,
                                                                             device))
            out["+".join(opts) or "plain"] = {
                "loss": float(loss), "grads": [_numpy(g) for g in tree_leaves(grads)],
                "all_reduce_bytes": coll.summary()["bytes"]["all-reduce"]}
    return out


def _rank(device, dmesh, shapes: dict) -> dict:
    dryrun.SHAPES.update(shapes)  # the ranks re-import the module
    return {"cells": {name: _real_cell(device, dmesh, name) for name in CELLS},
            "remat": _remat_rank(device, dmesh)}


@pytest.fixture(scope="module")
def ranks():
    return workergroup.spawn_group(_rank, 4, backend="gloo", device="cpu",
                                   timeout=LAUNCH_TIMEOUT_S, mesh=MESH, args=(SHAPES,))


@pytest.fixture
def shapes(monkeypatch):
    for name, info in SHAPES.items():
        monkeypatch.setitem(dryrun.SHAPES, name, info)


def _fake(name: str) -> dict:
    arch, shape, opts = CELLS[name]
    rec = dryrun.run_cell(arch, shape, False, cfg_override=_cfg(arch, opts), mesh=MESH,
                          device="cpu")
    assert rec["status"] == "ok" and rec["depth"] == "full", rec
    return rec


@pytest.mark.parametrize("name", list(CELLS))
def test_fake_mesh_collectives_equal_a_real_groups(name, ranks, shapes):
    """Kind by kind, counts and bytes: the fake run's record is what rank 0
    of the gloo group issues for the same program."""
    want = ranks[0]["cells"][name]
    got = _fake(name)["collectives"]
    assert got == want, (name, got, want)
    assert got["total_bytes"] > 0


def test_remat_save_tp_saves_all_reduce_bytes_not_values(ranks, shapes):
    plain, saved = (_fake(n)["collectives"]["bytes"]["all-reduce"]
                    for n in ("lm_train", "lm_train_save_tp"))
    assert saved < plain, (saved, plain)
    for rank, out in enumerate(ranks):
        a, b = out["remat"]["plain"], out["remat"]["remat_save_tp"]
        assert b["all_reduce_bytes"] < a["all_reduce_bytes"], rank
        assert abs(b["loss"] - a["loss"]) <= RTOL * abs(a["loss"]), rank
        for i, (g, w) in enumerate(zip(b["grads"], a["grads"], strict=True)):
            tol = GRAD_RTOL * max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= tol, (rank, i)


def test_no_device_mesh_no_collectives():
    model = tbuild(_cfg("internlm2-1.8b"), "cpu")
    batch = SyntheticCorpus(model.cfg, 2, 8, seed=0).make_batch(0)
    with meshctx.Collectives() as coll:
        value_and_grad(model, model.init(0), distribute_batch(batch, None, "cpu"))
    assert coll.records == []
    assert coll.summary() == {"bytes": dict.fromkeys(meshctx.COLLECTIVES, 0),
                              "counts": dict.fromkeys(meshctx.COLLECTIVES, 0),
                              "total_bytes": 0}


def test_fake_device_mesh_refuses_a_live_group_and_leaves_none(tmp_path):
    import torch.distributed as dist

    with fake_device_mesh({"data": 2, "model": 4}, "cpu") as dm:
        assert dist.get_world_size() == 8 and dm.mesh_dim_names == ("data", "model")
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            with fake_device_mesh(MESH):
                pass
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


_REF_EXTRACT = r"""
import json, sys
from repro.launch.roofline import _extract
rec = json.loads(sys.argv[1])
print(json.dumps(_extract(rec)["coll_bytes"]))
"""


def test_roofline_collective_term_is_the_references_formula(shapes):
    arch, shape = "internlm2-1.8b", "mesh_roofline"
    got = roofline.analyze_cell(arch, shape, cfg_override=_cfg(arch))
    assert got["status"] == "ok"
    rec = dryrun.run_cell(arch, shape, False, cfg_override=_cfg(arch), probes=True,
                          ce_chunk=SHAPES[shape]["batch"] * SHAPES[shape]["seq"] // 2)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref_rec = {"cost_analysis": {"flops_per_device": 0.0, "bytes_per_device": 0.0},
               "collectives": rec["collectives"]}
    proc = subprocess.run([sys.executable, "-c", _REF_EXTRACT, json.dumps(ref_rec)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = float(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert roofline.collective_bytes(rec["collectives"]) == want > 0
    assert got["per_device"]["coll_bytes"] == want
    assert got["terms"]["collective_s"] == want / ICI_BW
    assert got["dominant"] == max(got["terms"], key=got["terms"].get)


def test_positional_rows_are_made_without_the_table():
    """``Model._positional`` of one decode position late in the sequence:
    its allocations (``LiveBytes``) hold the row and the sum, never the
    (max_seq, d) table, and its values are the table's rows."""
    from repro_torch.models.layers import sinusoidal_positions

    cfg = _cfg("rwkv6-3b")
    model = tbuild(cfg, "cpu")
    x = torch.zeros(2, 1, cfg.d_model)
    with dryrun.LiveBytes() as live:
        y = model._positional(x, cfg.max_seq - 1)
    table = cfg.max_seq * cfg.d_model * 4
    assert 0 < live.peak <= 8 * cfg.d_model * 4 < table, (live.peak, table)
    want = sinusoidal_positions(cfg.max_seq, cfg.d_model)[-1]
    assert torch.equal(y[0, 0], want) and torch.equal(y[1, 0], want)


def test_rwkv_decode_cell_temp_holds_no_positional_table(monkeypatch):
    cfg = _cfg("rwkv6-3b")
    monkeypatch.setitem(dryrun.SHAPES, "rwkv_decode", dict(seq=32, batch=4, kind="decode"))
    rec = dryrun.run_cell("rwkv6-3b", "rwkv_decode", False, cfg_override=cfg, mesh=MESH,
                          probes=False)
    temp = rec["memory_analysis"]["temp_bytes"]
    assert 0 < temp < cfg.max_seq * cfg.d_model * 4, temp
