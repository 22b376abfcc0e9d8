"""The other model families on the device mesh: rwkv6, the jamba hybrid,
llama-3.2-vision and whisper, trained and decoded sharded on DTensor.

Every case runs on the port's own parameters from seed 0 (``Model.init``,
the same values in every process).  One JAX subprocess (4 host devices,
under ``jax.jit``), run after the ranks, takes each
family's parameters as numpy and writes its loss on the reference's
{data 2, model 2} mesh; where jax refuses a family's sharding it writes the
unsharded loss and says why (``why`` in the npz).  One 4-rank gloo group
on ``device="cpu"`` (``runtime.workergroup.spawn_group``, one launch, a
module fixture) runs the port (``meshctx.distribute``) on {data 2, model
2}, and two configurations that the TP degree does not divide on {data 2,
model 2} and {data 1, model 4} over the same ranks.
Held:

* the sharded loss within RTOL = 1e-5 (relative) and every gathered
  gradient within GRAD_RTOL = 1e-4 of its leaf's largest magnitude against
  the one-process port, and the loss within RTOL of the reference's;
* a prefill of PROMPT tokens and NEW greedy decode steps with the cache
  placed by ``Model.cache_specs`` (f32): the tokens equal to the
  one-process port's and every step's logits within LOGIT_RTOL = 1e-5 of
  max|logit|; ``generate`` on the mesh gives the same tokens;
* the cache's placements after the decode are ``cache_specs``' (sanitised);
* ``meshctx.local`` refuses a dim that its shards do not divide.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.launch import meshctx  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.runtime import workergroup  # noqa: E402
from repro_torch.training.data import SyntheticCorpus, distribute_batch  # noqa: E402
from repro_torch.training.train_step import value_and_grad  # noqa: E402
from repro_torch.training.tree import tree_leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, GRAD_RTOL, LOGIT_RTOL = 1e-5, 1e-4, 1e-5
B, S = 4, 16
PROMPT, NEW, MAX_SEQ = 8, 4, 16
LAUNCH_TIMEOUT_S = 300.0
FAMILIES = ("rwkv6-3b", "jamba-1.5-large-398b", "llama-3.2-vision-11b", "whisper-medium")
MESH = {"data": 2, "model": 2}
# configurations whose heads and vocab tp 2 and 4 do not divide: rwkv with
# 3 heads of 16, whisper with 3 heads and 3 K/V heads, both a vocab of 509
ODD = {"rwkv_odd": ("rwkv6-3b", dict(d_model=48, vocab_size=509)),
       "whisper_odd": ("whisper-medium", dict(num_heads=3, num_kv_heads=3, vocab_size=509))}
ODD_MESHES = {"tp2": {"data": 2, "model": 2}, "tp4": {"data": 1, "model": 4}}


_JAX_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
from repro import compat
import repro.configs as configs
from repro.launch import meshctx
from repro.models import build
from repro.training.data import SyntheticCorpus

archs, B, S = json.loads(sys.argv[3])
mesh = compat.make_mesh((2, 2), ("data", "model"), axis_types=compat.auto_axis_types(2))
given = np.load(sys.argv[2])
out = {}
for arch in archs:
    cfg = configs.get(arch).reduced()
    model = build(cfg)
    shapes = model.shapes()
    n = len(jax.tree.leaves(shapes))
    params = jax.tree.unflatten(jax.tree.structure(shapes),
                                [jnp.asarray(given[f"{arch}/{i}"]) for i in range(n)])
    batch = {k: jnp.asarray(v) for k, v in SyntheticCorpus(cfg, B, S, seed=0).make_batch(0).items()}
    loss = jax.jit(model.loss)
    try:
        with meshctx.use_mesh(mesh):
            out[f"loss/{arch}"] = np.asarray(loss(params, batch))
        out[f"sharded/{arch}"] = np.asarray(True)
    except Exception as e:  # the reference's own sharding refused on this jax
        out[f"loss/{arch}"] = np.asarray(loss(params, batch))
        out[f"sharded/{arch}"] = np.asarray(False)
        out[f"why/{arch}"] = np.asarray(f"{type(e).__name__}: {e}"[:500])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory) -> dict:
    """The reference's losses on the port's parameters, from its subprocess
    (run after the ranks: the two together would load the box's cores)."""
    tmp = tmp_path_factory.mktemp("families_ref")
    np.savez(tmp / "params.npz", **{
        f"{name}/{i}": leaf.numpy()
        for name in FAMILIES
        for i, leaf in enumerate(tree_leaves(_params(tbuild(_cfg(name), "cpu"))))})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(tmp / "ref.npz"),
                           str(tmp / "params.npz"), json.dumps([list(FAMILIES), B, S])],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "ref.npz") as z:
        return {k: z[k] for k in z.files}


def _cfg(name: str):
    if name in ODD:
        arch, kw = ODD[name]
        return dataclasses.replace(tcfg.get(arch).reduced(), **kw)
    return tcfg.get(name).reduced()


def _params(model) -> dict:
    """The port's parameters from seed 0, f32."""
    return model.init(0)


def _batch(cfg) -> dict:
    return SyntheticCorpus(cfg, B, S, seed=0).make_batch(0)


def _numpy(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().float().cpu().numpy()


def _decode(model, params, batch: dict, dmesh, device) -> dict:
    """Prefill PROMPT tokens (with the batch's memory), then NEW greedy
    decode steps on an f32 cache: each step's tokens and logits (the
    prefill's last first), the cache's leaves' placements, and
    ``generate``'s tokens."""
    from repro_torch.serving.serve_step import generate, make_prefill_step

    placed = distribute_batch({k: v[:, :PROMPT] if k == "tokens" else v
                               for k, v in batch.items() if k != "labels"}, dmesh, device)
    extras = {k: v for k, v in placed.items() if k != "tokens"}
    with torch.no_grad():
        logits, cache = make_prefill_step(model, MAX_SEQ, torch.float32)(params, placed)
        toks, logs = [], []
        for _ in range(NEW + 1):
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            toks.append(_numpy(tok))
            logs.append(_numpy(logits[:, -1]))
            if len(toks) <= NEW:
                logits, cache = model.decode_step(params, cache, tok)
        gen = generate(model, params, placed["tokens"], steps=NEW + 1, max_seq=MAX_SEQ,
                       extras=extras, cache_dtype=torch.float32)
    placements = [str(tuple(getattr(t, "placements", ()))) for t in _cache_leaves(cache)]
    return {"tokens": np.concatenate(toks, 1), "logits": np.stack(logs, 1),
            "generate": _numpy(gen), "placements": placements}


def _cache_leaves(cache: dict) -> list:
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in t:
                walk(t[k])
        elif isinstance(t, list):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            out.append(t)
    walk(cache["groups"])
    return out


def _case(name, model_params, dmesh, device) -> dict:
    model, params = model_params
    cfg = model.cfg
    with meshctx.use_mesh(dmesh):
        sharded = meshctx.distribute(params, model.specs(), dmesh)
        loss, grads = value_and_grad(model, sharded, distribute_batch(_batch(cfg), dmesh, device))
        out = {"loss": float(loss), "grads": [_numpy(g) for g in tree_leaves(grads)]}
        out.update(_decode(model, sharded, _batch(cfg), dmesh, device))
        shapes = model._init_cache(B, MAX_SEQ, torch.float32)
        out["cache_specs"] = [
            str(tuple(meshctx.placements(meshctx.fitted(tuple(t.shape), s), dmesh)))
            for t, s in zip(_cache_leaves(shapes), _spec_leaves(model.cache_specs(shapes)),
                            strict=True)]
    return out


def _spec_leaves(specs: dict) -> list:
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in t:
                walk(t[k])
        elif isinstance(t, list):  # a mamba slot: [conv, h]
            for v in t:
                walk(v)
        else:
            out.append(t)
    walk(specs["groups"])
    return out


def _families_rank(device, dmesh) -> dict:
    """Every family on {data 2, model 2} and the odd configurations on
    both meshes of the same ranks.  Returns numpy only."""
    from repro_torch.launch.mesh import device_mesh

    out = {}
    for name in FAMILIES:
        model = tbuild(_cfg(name), device)
        out[name] = _case(name, (model, _params(model)), dmesh, device)
    meshes = {"tp2": dmesh, "tp4": device_mesh(ODD_MESHES["tp4"], device.type)}
    for name in ODD:
        model = tbuild(_cfg(name), device)
        params = _params(model)
        for tag, m in meshes.items():
            out[f"{name}/{tag}"] = _case(name, (model, params), m, device)
    with meshctx.use_mesh(meshes["tp4"]):
        try:
            meshctx.local(lambda t: t, ((None, None, "model"),), ((None, None, "model"),))(
                meshctx.distribute({"x": torch.zeros(2, 3, 6)}, {"x": ()},
                                   meshes["tp4"])["x"])
            out["local_refused"] = ""
        except ValueError as e:
            out["local_refused"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks():
    return workergroup.spawn_group(_families_rank, 4, backend="gloo", device="cpu",
                                   timeout=LAUNCH_TIMEOUT_S, mesh=MESH)


_ONE: dict = {}


def _one_process(name: str) -> dict:
    """The one-process port on the case's inputs: loss, gradients, decode."""
    if name not in _ONE:
        model = tbuild(_cfg(name), "cpu")
        params = _params(model)
        loss, grads = value_and_grad(model, params, distribute_batch(_batch(model.cfg), None,
                                                                     "cpu"))
        out = {"loss": float(loss), "grads": [g.numpy() for g in tree_leaves(grads)]}
        out.update(_decode(model, params, _batch(model.cfg), None, "cpu"))
        _ONE[name] = out
    return _ONE[name]


def _held_grads(got: list, want: list, zero: list, what: str) -> None:
    """Each leaf within GRAD_RTOL of its largest magnitude; a leaf whose
    gradient is zero in exact arithmetic (``zero``: a key bias, to which
    the softmax is invariant) within GRAD_RTOL of the tree's largest, as
    ``test_torch_mixers.py`` holds it."""
    assert len(got) == len(want), what
    largest = max(float(np.abs(b).max()) for b in want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        err = float(np.abs(a - b).max())
        tol = GRAD_RTOL * (largest if zero[i] else max(float(np.abs(b).max()), 1e-30))
        assert err <= tol, f"{what} leaf {i} {a.shape}: max err {err:.3e} > {tol:.3e}"


def _key_biases(name: str) -> list:
    """Which leaves (in ``tree_leaves`` order) are a key bias."""
    flags = []

    def walk(t, key):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], k)
        else:
            flags.append(key == "bk")
    walk(tbuild(_cfg(name), "meta").shapes(), None)
    return flags


def _held_decode(got: dict, want: dict, what: str) -> None:
    np.testing.assert_array_equal(got["tokens"], want["tokens"], err_msg=what)
    np.testing.assert_array_equal(got["generate"], want["tokens"], err_msg=what)
    scale = float(np.abs(want["logits"]).max())
    err = float(np.abs(got["logits"] - want["logits"]).max())
    assert err <= LOGIT_RTOL * scale, (what, err, scale)


CASES = list(FAMILIES) + [f"{n}/{t}" for n in ODD for t in ODD_MESHES]


@pytest.mark.parametrize("case", CASES)
def test_sharded_loss_and_grads_match_one_process(case, ranks):
    name = case.split("/")[0]
    want = _one_process(name)
    for rank, out in enumerate(ranks):
        got = out[case]
        assert abs(got["loss"] - want["loss"]) <= RTOL * abs(want["loss"]), (case, rank)
        _held_grads(got["grads"], want["grads"], _key_biases(name), f"{case} rank {rank}")


@pytest.mark.parametrize("case", CASES)
def test_sharded_decode_matches_one_process(case, ranks):
    """Prefill and cached greedy decode on the placed cache: the tokens the
    one-process port's, every step's logits within LOGIT_RTOL of
    max|logit|, and the cache still placed as ``cache_specs`` says."""
    name = case.split("/")[0]
    want = _one_process(name)
    for rank, out in enumerate(ranks):
        got = out[case]
        _held_decode(got, want, f"{case} rank {rank}")
        assert got["placements"] == got["cache_specs"], (case, rank)


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_loss_matches_reference(name, reference, ranks):
    """The sharded loss against the reference's on the same mesh (or, where
    jax refuses the family's sharding, its unsharded loss)."""
    want = float(reference[f"loss/{name}"])
    got = ranks[0][name]["loss"]
    assert abs(got - want) <= RTOL * abs(want), (name, got, want,
                                                 str(reference.get(f"why/{name}", "")))


def test_local_refuses_a_dim_its_shards_do_not_divide(ranks):
    """``meshctx.local`` on a dim of 6 over 4 model shards raises, naming
    the argument (``local_map`` would give the output an even split's
    shape)."""
    for out in ranks:
        assert "does not divide" in out["local_refused"] and "(2, 3, 6)" in out["local_refused"]


def test_one_process_paths_unchanged_without_a_device_mesh():
    """With no ``DeviceMesh`` every placement call is the tensor itself:
    ``fitted``/``fit`` leave an unsharded spec alone and ``zeros`` is a
    plain tensor."""
    assert meshctx.fit(6, "model") is None
    t = meshctx.zeros((2, 3), torch.float32, "cpu", ("dp", "model"))
    assert type(t) is torch.Tensor and t.shape == (2, 3)
    with meshctx.use_mesh({"data": 2, "model": 4}):
        assert meshctx.fitted((4, 6, 8), ("data", "model", None)) == ("data", None, None)
        assert meshctx.fit(8, "model") == "model" and meshctx.fit(6, "model") is None
        assert meshctx.fit(4, "dp") == "data"
