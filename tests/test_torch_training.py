"""The port's training path against the JAX package's, on the CPU.

The same seeded numpy inputs go through the reference (under ``jax.jit``)
and the port, with the reference's parameters carried across by
``models.convert.params_from_numpy``, at the ``reduced()`` internlm2-1.8b
and qwen3-moe-30b-a3b:

* ``SyntheticCorpus`` batches bit for bit;
* ``Model.loss`` and every gradient leaf: the chunked cross entropy within
  ``RTOL`` = 1e-5 (the loss relative to itself, a gradient leaf relative
  to its largest magnitude: f32 sums in other orders); the fused one's
  bf16 backward within ``BF16_RTOL`` = 2^-7 of each leaf's largest
  magnitude (one bf16 rounding of the same f32 value, then carried down
  the layers);
* AdamW with f32 and bf16 state, ``clip_by_global_norm``, the schedule;
* a 5-step loss and grad_norm trace from the same init and batches;
* the MoE family with ``opt_coded_moe`` off, on, and with two workers
  dead, each gradient equal to the plain expert FFN's within ``RTOL``;
* ``topk_sparsify`` masks bit for bit, ``coded_aggregate`` against the
  reference and the exact sum;
* checkpoints written by either package restored by the other, bf16
  state as the reference's own ``<V2`` words, and the coded checkpoint's
  manifest, its restore with a third of the targets lost, and its refusal
  when rank is lost.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfg  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import compress as jcompress  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.data import SyntheticCorpus as JCorpus  # noqa: E402
from repro.training.train_step import make_train_step as jmake_train_step  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.core.decoder import DecodingError  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import compress as tcompress  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.data import SyntheticCorpus as TCorpus  # noqa: E402
from repro_torch.training.train_step import (make_eval_step, make_train_step,  # noqa: E402
                                             value_and_grad)
from repro_torch.training.tree import tree_leaves, tree_map, tree_unflatten  # noqa: E402

RTOL = 1e-5
BF16_RTOL = 2.0 ** -7
DEAD = (0, 1)  # of the reduced qwen3's 6 expert-code workers; the rest keep rank


def _close(got: torch.Tensor, want, rtol: float, what: str) -> None:
    want = np.asarray(want, dtype=np.float32)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    tol = rtol * max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, f"{what}: max err {err:.3e} > {tol:.3e}"


def _close_trees(got: dict, want, rtol: float, what: str) -> None:
    got_l, want_l = tree_leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert tuple(g.shape) == tuple(w.shape), (what, i)
        _close(g, w, rtol, f"{what} leaf {i} {tuple(g.shape)}")


def _loss_close(got, want, what: str) -> None:
    assert abs(float(got) - float(want)) <= RTOL * abs(float(want)), (what, float(got),
                                                                       float(want))


@functools.lru_cache(maxsize=None)
def _pair(name: str, opts: tuple = ()):
    """The JAX model and the port's, the reference's init carried across
    (numpy tree kept, so each test makes its own copies)."""
    jc, tc = jcfg.get(name).reduced(), tcfg.get(name).reduced()
    if opts:
        jc, tc = jc.with_opts(opts), tc.with_opts(opts)
    jm, tm = jbuild(jc), tbuild(tc, "cpu")
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    return jm, tm, tree


def _batch(cfg, step: int = 0, B: int = 2, S: int = 16) -> dict:
    return JCorpus(cfg, B, S, seed=0).make_batch(step)


def _jax_value_and_grad(jm, tree, batch, D=None):
    fn = jax.jit(jax.value_and_grad(jm.loss))
    args = (jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    if D is None:
        return fn(*args)
    with jmoe.coded_moe_decode(jnp.asarray(D)):
        return fn(*args)


# ------------------------------- data ---------------------------------------

@pytest.mark.parametrize("name", ["internlm2-1.8b", "whisper-medium",
                                  "llama-3.2-vision-11b"])
def test_synthetic_corpus_batches_bit_for_bit(name):
    jc, tc = jcfg.get(name).reduced(), tcfg.get(name).reduced()
    want, got = JCorpus(jc, 3, 20, seed=7), iter(TCorpus(tc, 3, 20, seed=7))
    for step in range(3):
        w, g = want.make_batch(step), next(got)
        assert sorted(w) == sorted(g)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), (step, k)


# ------------------------------- loss ---------------------------------------

@pytest.mark.parametrize("ce,chunk,masked", [("chunked", None, False),
                                             ("chunked", 12, True),
                                             ("fused", 12, True)])
def test_loss_and_grads_match_reference(ce, chunk, masked):
    """chunk 12 over 32 tokens pads the last chunk with label -1; masked
    batches also carry -1 labels of their own."""
    opts = ("fused_ce",) if ce == "fused" else ()
    jm, tm, tree = _pair("internlm2-1.8b", opts)
    jm.ce_chunk = tm.ce_chunk = chunk
    try:
        batch = _batch(jm.cfg)
        if masked:
            batch["labels"] = batch["labels"].copy()
            batch["labels"][:, :3] = -1
        jl, jg = _jax_value_and_grad(jm, tree, batch)
        tl, tg = value_and_grad(tm, params_from_numpy(tm, tree), batch)
        evl = make_eval_step(tm)(params_from_numpy(tm, tree), batch)
    finally:
        jm.ce_chunk = tm.ce_chunk = None
    _loss_close(tl, jl, "loss")
    assert float(evl) == float(tl)
    _close_trees(tg, jg, BF16_RTOL if ce == "fused" else RTOL, f"{ce} grads")


def test_fused_and_chunked_agree_up_to_the_bf16_backward():
    _, tm, tree = _pair("internlm2-1.8b")
    _, tf, _ = _pair("internlm2-1.8b", ("fused_ce",))
    batch = _batch(tm.cfg)
    lc, gc = value_and_grad(tm, params_from_numpy(tm, tree), batch)
    lf, gf = value_and_grad(tf, params_from_numpy(tf, tree), batch)
    assert float(lc) == float(lf)  # the same f32 forward
    _close_trees(gf, jax.tree.map(lambda t: t.numpy(), gc), BF16_RTOL, "fused vs chunked")


def test_remat_changes_no_value():
    _, tm, tree = _pair("internlm2-1.8b")
    assert tm.cfg.remat
    plain = tbuild(dataclasses.replace(tm.cfg, remat=False), "cpu")
    batch = _batch(tm.cfg)
    lr, gr = value_and_grad(tm, params_from_numpy(tm, tree), batch)
    lp, gp = value_and_grad(plain, params_from_numpy(plain, tree), batch)
    assert float(lr) == float(lp)
    for a, b in zip(tree_leaves(gr), tree_leaves(gp)):
        assert torch.equal(a, b)


# -------------------------------- MoE ---------------------------------------

def _dead_decode(cfg) -> np.ndarray:
    surv = np.ones(tmoe.coded_moe_num_workers(cfg), dtype=bool)
    surv[list(DEAD)] = False
    return tmoe.coded_moe_decode_matrix(cfg, surv)


def _port_grads(tm, tree, batch, D=None):
    params = params_from_numpy(tm, tree)
    if D is None:
        return value_and_grad(tm, params, batch)
    with tmoe.coded_moe_decode(torch.from_numpy(D)):
        return value_and_grad(tm, params, batch)


@pytest.mark.parametrize("arm", ["plain", "coded_dead"])
def test_moe_loss_and_grads_match_reference(arm):
    opts = ("coded_moe",) if arm != "plain" else ()
    jm, tm, tree = _pair("qwen3-moe-30b-a3b", opts)
    batch = _batch(tm.cfg)
    D = _dead_decode(tm.cfg) if arm == "coded_dead" else None
    jl, jg = _jax_value_and_grad(jm, tree, batch, D)
    tl, tg = _port_grads(tm, tree, batch, D)
    _loss_close(tl, jl, arm)
    _close_trees(tg, jg, RTOL, f"moe {arm} grads")


def test_coded_moe_grads_equal_the_plain_ffns():
    """The expert code, all workers alive and with two dead (the decode
    rebound), gives the plain expert FFN's loss and gradients."""
    _, tp, tree = _pair("qwen3-moe-30b-a3b")
    _, tc, _ = _pair("qwen3-moe-30b-a3b", ("coded_moe",))
    batch = _batch(tp.cfg)
    pl, pg = _port_grads(tp, tree, batch)
    want = jax.tree.map(lambda t: t.numpy(), pg)
    for D in (None, _dead_decode(tc.cfg)):
        cl, cg = _port_grads(tc, tree, batch, D)
        _loss_close(cl, pl, "coded vs plain")
        _close_trees(cg, want, RTOL, "coded vs plain grads")


def test_remat_recompute_sees_the_forward_decode_matrix():
    """Autograd may recompute a group on another thread (its device
    thread on a card); the recompute must use the decode matrix the
    forward ran under.  A deliberately scaled D makes any other visible."""
    _, tm, tree = _pair("qwen3-moe-30b-a3b", ("coded_moe",))
    batch = _batch(tm.cfg)
    D = torch.from_numpy(2.0 * tmoe.coded_moe_decode_matrix(tm.cfg))
    _, want = _port_grads(tm, tree, batch, D.numpy())

    params = params_from_numpy(tm, tree)
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with tmoe.coded_moe_decode(D):
        loss = tm.loss(tree_unflatten(params, live), batch)
    out = {}
    worker = threading.Thread(target=lambda: out.update(g=torch.autograd.grad(loss, live)))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and "g" in out
    for a, b in zip(out["g"], tree_leaves(want)):
        assert torch.equal(a, b)


# ----------------------------- optimizer ------------------------------------

def _tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((6, 5))).astype(np.float32),
            "blk": {"b": (scale * rng.standard_normal(7)).astype(np.float32),
                    "a": (scale * rng.standard_normal((3, 4, 2))).astype(np.float32)}}


def _torch_tree(tree: dict) -> dict:
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(dtype, monkeypatch):
    """Three updates on a schedule.  f32: within 1e-6 of each leaf's
    largest magnitude (the same f32 arithmetic, XLA's pow/sqrt against
    torch's); bf16 state: within one bf16 rounding (2^-8) of it.  The
    in-place form, in pieces of 7 elements here, is ``update`` bit for
    bit."""
    monkeypatch.setattr(topt, "PIECE", 7)
    sched = dict(peak_lr=1e-2, warmup=2, total=10)
    jo = jopt.AdamW(lr=jopt.cosine_warmup_schedule(**sched),
                    state_dtype=getattr(jnp, dtype))
    to = topt.AdamW(lr=topt.cosine_warmup_schedule(**sched),
                    state_dtype=getattr(torch, dtype))
    params = _tree(0)
    jp, jstate = jax.tree.map(jnp.asarray, params), jo.init(jax.tree.map(jnp.asarray, params))
    tp, tstate = _torch_tree(params), to.init(_torch_tree(params))
    tp2, tstate2 = _torch_tree(params), to.init(_torch_tree(params))
    assert all(m.dtype == getattr(torch, dtype) for m in tree_leaves(tstate["m"]))
    jupdate = jax.jit(jo.update)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    for step in range(3):
        grads = _tree(10 + step, 0.1)
        ju, jstate = jupdate(jax.tree.map(jnp.asarray, grads), jstate, jp)
        tu, tstate = to.update(_torch_tree(grads), tstate, tp)
        assert tstate["count"].dtype == torch.int32 and int(tstate["count"]) == step + 1
        _close_trees(tu, ju, 1e-6, f"updates {step}")
        _close_trees(tstate["m"], jstate["m"], tol, f"m {step}")
        _close_trees(tstate["v"], jstate["v"], tol, f"v {step}")
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
        _close_trees(tp, jp, 1e-6, f"params {step}")
        # the in-place form does the same arithmetic, bit for bit
        to.update_(_torch_tree(grads), tstate2, tp2)
        for a, b in zip(tree_leaves({"p": tp, "s": tstate}),
                            tree_leaves({"p": tp2, "s": tstate2})):
            assert torch.equal(a, b)


def test_clip_global_norm_and_schedule_match_reference():
    tree = _tree(3)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    tc, tn = topt.clip_by_global_norm(_torch_tree(tree), 1.0)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    _close_trees(tc, jc, 1e-6, "clipped")
    leaves = tree_leaves(_torch_tree(tree))
    assert float(topt.clip_by_global_norm_(leaves, 1.0)) == float(tn)
    assert abs(float(topt.global_norm(leaves)) - 1.0) <= 1e-6
    unclipped, _ = topt.clip_by_global_norm(_torch_tree(tree), 1e6)
    for a, b in zip(tree_leaves(unclipped), tree_leaves(_torch_tree(tree))):
        assert torch.equal(a, b)

    jl = jopt.cosine_warmup_schedule(1e-3, warmup=10, total=100)
    tl = topt.cosine_warmup_schedule(1e-3, warmup=10, total=100)
    counts = np.arange(0, 121, dtype=np.int32)
    want = np.asarray(jax.vmap(jl)(jnp.asarray(counts)))
    got = tl(torch.from_numpy(counts)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert float(tl(torch.tensor(0, dtype=torch.int32))) == 0.0


def test_five_step_trace_matches_reference():
    """The same init and batches, five steps of AdamW on a warm-up
    schedule: loss and grad_norm within 1e-4 relative, and the parameters
    within 2e-3 of each leaf's largest magnitude after the last step.  The
    gradients differ by up to 1e-5 of their leaf's largest (f32 sums in
    other orders), and Adam's normalisation turns that into up to an
    lr-sized step where a gradient is near 0: no tighter bound holds in
    general (2 x the sum of the lr, 0.06 here, always does)."""
    jm, tm, tree = _pair("internlm2-1.8b")
    sched = dict(peak_lr=1e-2, warmup=2, total=5)
    jo = jopt.AdamW(lr=jopt.cosine_warmup_schedule(**sched))
    to = topt.AdamW(lr=topt.cosine_warmup_schedule(**sched))
    jstep = jax.jit(jmake_train_step(jm, jo))
    tstep = make_train_step(tm, to)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jo.init(jp)
    tp = params_from_numpy(tm, tree)
    tstate = to.init(tp)
    losses = []
    for step in range(5):
        batch = _batch(jm.cfg, step)
        jp, jstate, jmet = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, tstate, tmet = tstep(tp, tstate, batch)
        for key in ("loss", "grad_norm"):
            w, g = float(jmet[key]), float(tmet[key])
            assert abs(g - w) <= 1e-4 * abs(w), (step, key, g, w)
        losses.append(float(tmet["loss"]))
    assert losses[-1] < losses[0]
    _close_trees(tp, jp, 2e-3, "params after 5 steps")


# ---------------------------- compression -----------------------------------

def test_topk_sparsify_masks_bit_for_bit():
    rng = np.random.default_rng(5)
    # values on a coarse grid: many ties at the threshold
    tree = {"w": np.round(rng.standard_normal((16, 12)) * 4).astype(np.float32) / 4,
            "b": {"x": rng.standard_normal(50).astype(np.float32)}}
    for frac in (0.1, 0.33, 1e-4):
        jk, jr = jcompress.topk_sparsify(jax.tree.map(jnp.asarray, tree), frac)
        tk, tr = tcompress.topk_sparsify(_torch_tree(tree), frac)
        for g, w in zip(tree_leaves(tk) + tree_leaves(tr), jax.tree.leaves(jk) + jax.tree.leaves(jr)):
            assert np.array_equal(g.numpy(), np.asarray(w)), frac
    g = {"w": rng.standard_normal((64, 64)).astype(np.float32)}
    jres = tres = None
    for _ in range(4):
        js, jres = jcompress.error_feedback_update(jax.tree.map(jnp.asarray, g), jres, 0.1)
        ts, tres = tcompress.error_feedback_update(_torch_tree(g), tres, 0.1)
        assert np.array_equal(ts["w"].numpy(), np.asarray(js["w"]))
        assert np.array_equal(tres["w"].numpy(), np.asarray(jres["w"]))


def test_coded_aggregate_exact_and_fault_tolerant():
    """The reference's case: four sparse shards, m = n = 2, 8 aggregators;
    the port decodes its float64 coded sums to the f32 sum exactly (to one
    f32 rounding), the reference to within its own test's 1e-5."""
    rng = np.random.default_rng(1)
    shards = [np.zeros(1000, np.float32) for _ in range(4)]
    for s in shards:
        idx = rng.choice(1000, size=50, replace=False)
        s[idx] = rng.standard_normal(50)
    want = shards[0] + shards[1] + shards[2] + shards[3]
    for survivors in (None, [0, 1, 3, 4, 6, 7]):
        got, stats = tcompress.coded_aggregate(shards, m=2, n=2, num_workers=8,
                                               survivors=survivors, device="cpu")
        ref, ref_stats = jcompress.coded_aggregate(shards, m=2, n=2, num_workers=8,
                                                   survivors=survivors)
        assert got.dtype == torch.float32 and got.shape == (1000,)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=float(np.spacing(np.abs(want).max())))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
        assert stats.as_dict() == ref_stats.__dict__
    with pytest.raises(DecodingError):
        tcompress.coded_aggregate(shards, m=2, n=2, num_workers=8, survivors=[0, 1, 2],
                                  device="cpu")


# ---------------------------- checkpoints -----------------------------------

def _np_words(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _state(dtype: str):
    """The reduced internlm2's params and a one-step AdamW state in
    ``dtype``, in both packages (the same values)."""
    _, tm, tree = _pair("internlm2-1.8b")
    jo = jopt.AdamW(lr=1e-3, state_dtype=getattr(jnp, dtype))
    jp = jax.tree.map(jnp.asarray, tree)
    grads = jax.tree.map(lambda a: 0.1 * jnp.ones_like(a) + a, jp)
    _, jstate = jax.jit(jo.update)(grads, jo.init(jp), jp)
    tstate = {"count": torch.tensor(int(jstate["count"]), dtype=torch.int32),
              "m": tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(
                  getattr(torch, dtype)), jax.tree.map(np.asarray, jstate["m"])),
              "v": tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(
                  getattr(torch, dtype)), jax.tree.map(np.asarray, jstate["v"]))}
    return tm, jp, jstate, params_from_numpy(tm, tree), tstate


def _same_values(got: dict, want) -> None:
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        if w.dtype.kind == "V" or str(w.dtype) == "bfloat16":
            assert g.dtype == torch.bfloat16
            w = w.view(np.int16)
        assert np.array_equal(_np_words(g), w)


def test_checkpoint_round_trip(tmp_path):
    tm, _, _, tp, tstate = _state("bfloat16")
    tckpt.save_checkpoint(tmp_path, 7, tp, tstate, extra={"k": 1})
    assert tckpt.latest_step(tmp_path) == 7 and tckpt.latest_step(tmp_path / "x") is None
    p2, o2, step = tckpt.restore_checkpoint(tmp_path, tp, tstate)
    assert step == 7
    for a, b in zip(tree_leaves({"p": tp, "s": tstate}),
                    tree_leaves({"p": p2, "s": o2})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(tmp_path / "empty", tp)
    saver = tckpt.AsyncCheckpointer(tmp_path)
    saver.save(9, tp, tstate)
    for p in tree_leaves(tp):  # the snapshot was taken before this
        p.add_(1.0)
    saver.wait()
    p3, _, _ = tckpt.restore_checkpoint(tmp_path, tp, tstate)
    for a, b in zip(tree_leaves(p3), tree_leaves(p2)):
        assert torch.equal(a, b)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """f32: the reference's file restores in the port and the port's in
    the reference; both packages' files are the same bytes."""
    tm, jp, jstate, tp, tstate = _state("float32")
    jckpt.save_checkpoint(tmp_path / "jax", 3, jp, jstate)
    p, o, step = tckpt.restore_checkpoint(tmp_path / "jax", tp, tstate)
    assert step == 3
    _same_values(p, jp)
    _same_values(o, jstate)
    tckpt.save_checkpoint(tmp_path / "port", 3, tp, tstate)
    jp2, jo2, _ = jckpt.restore_checkpoint(tmp_path / "port", jp, jstate)
    _same_values(tp, jp2)
    _same_values(tstate, jo2)
    for name in ("params.npz", "opt_state.npz"):
        assert ((tmp_path / "port" / "step_00000003" / name).read_bytes()
                == (tmp_path / "jax" / "step_00000003" / name).read_bytes())


def test_bf16_state_crosses_as_the_references_words(tmp_path):
    """bf16 m/v: the reference writes ``<V2`` words (read back by numpy
    as ``|V2``); the port reads them into bf16 and writes the same words,
    header and all."""
    tm, jp, jstate, tp, tstate = _state("bfloat16")
    jckpt.save_checkpoint(tmp_path / "jax", 1, jp, jstate)
    _, o, _ = tckpt.restore_checkpoint(tmp_path / "jax", tp, tstate)
    _same_values(o, jstate)
    tckpt.save_checkpoint(tmp_path / "port", 1, tp, o)
    names = []
    with zipfile.ZipFile(tmp_path / "jax" / "step_00000001" / "opt_state.npz") as zj, \
            zipfile.ZipFile(tmp_path / "port" / "step_00000001" / "opt_state.npz") as zt:
        assert zj.namelist() == zt.namelist()
        for name in zj.namelist():
            raw = zj.read(name)
            assert zt.read(name) == raw, name
            if b"'descr': '<V2'" in raw:
                names.append(name)
    assert len(names) == 2 * len(tree_leaves(tp))  # every m and v leaf


def test_coded_checkpoint_manifest_restore_and_refusal(tmp_path):
    """m = n = 4 over 24 targets: the manifest's ``M_rows`` and leaf
    tables are the reference's bit for bit; the port restores its own
    checkpoint exactly from all targets and with a third of them lost
    (so does the reference, within 1e-6), and the reference's f32-target
    checkpoint within that package's own 1e-4; a subset that loses rank
    raises ``DecodingError``."""
    _, tm, tree = _pair("internlm2-1.8b")
    tp = params_from_numpy(tm, tree)
    jp = jax.tree.map(jnp.asarray, tree)
    want = tckpt.save_coded_checkpoint(tmp_path / "port", 2, tp, device="cpu")
    ref = jckpt.save_coded_checkpoint(tmp_path / "jax", 2, jp)
    assert want["M_rows"] == ref["M_rows"]
    for key in ("m", "n", "num_targets", "pad", "total", "leaf_shapes", "leaf_dtypes"):
        assert want[key] == ref[key], key
    lost_third = list(range(8, 24))
    for available in (None, lost_third):
        got, stats = tckpt.restore_coded_checkpoint(tmp_path / "port", 2, tp,
                                                    available=available, device="cpu")
        assert stats.peels + stats.roots == 16
        for a, b in zip(tree_leaves(got), tree_leaves(tp)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        jgot, _ = jckpt.restore_coded_checkpoint(tmp_path / "port", 2, jp,
                                                 available=available)
        _close_trees(tp, jgot, 1e-6, "port's targets in the reference")
        # the reference's f32 targets: the port's restore is as close as
        # the reference's own restore of them (the same schedule over the
        # same rounded sums), and within that package's test's 1e-4 there
        from_ref, _ = tckpt.restore_coded_checkpoint(tmp_path / "jax", 2, tp,
                                                     available=available, device="cpu")
        ref_own, _ = jckpt.restore_coded_checkpoint(tmp_path / "jax", 2, jp,
                                                    available=available)
        port_err = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(from_ref), tree_leaves(tp)))
        ref_err = max(float(np.abs(np.asarray(a) - b.numpy()).max()) for a, b in zip(
            jax.tree.leaves(ref_own), tree_leaves(tp)))
        assert port_err <= 1.1 * ref_err
    for available in ([0], [0, 1, 2, 3, 4, 5, 6, 7, 10, 12, 13, 14, 15, 17, 18, 22]):
        with pytest.raises(DecodingError):
            tckpt.restore_coded_checkpoint(tmp_path / "port", 2, tp, available=available,
                                           device="cpu")
