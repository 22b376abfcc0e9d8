"""The port's mamba, rwkv and cross-attention mixers and the families they
make (hybrid jamba, ssm rwkv6, vlm llama-3.2-vision, encdec whisper)
against the JAX package's, on the CPU, at the ``reduced()`` sizes.

* ``mamba_apply``, ``rwkv_apply``, ``channel_mix_apply`` and
  ``cross_attention`` on the same seeded numpy inputs and weights, with
  and without a carried state: outputs and new states within ``RTOL`` =
  1e-5 of the reference's largest magnitude in f32 (f32 sums in other
  orders), and within ``BF16_RTOL`` = 2^-5 in bf16 (the reference's jitted
  bf16 keeps excess f32 precision between some ops where the port rounds
  each op to bf16; one bf16 rounding is 2^-8 relative, and a few of them
  compound through the scan and the gated products);
* the reference's cached rwkv decode stores the residual stream as the
  channel mix's token-shift state where its forward shifts the normed
  stream: with the channel mix's ``mu`` at 0.5 its decode departs from its
  forward by more than 1e-4 of max|logit|, while the port's (which stores
  the channel mix's input) stays within 1e-5 of its own forward;
* the cache after a bf16-cache prefill, leaf for leaf in the reference's
  dtypes (the states leave the cache's dtype; the self-attention k/v keep
  it), and decode on it giving the reference's logits;
* ``Model.loss`` and every gradient leaf against ``jax.value_and_grad``,
  remat on and off, within ``RTOL`` (the loss relative to itself, each
  leaf relative to its largest magnitude);
* ``generate`` with ``vision`` / ``frames`` giving the reference's greedy
  tokens, and ``ServingEngine`` serving the reduced jamba (its MoE layers
  carry the coded jobs) with the reference's greedy tokens, where the
  reference's engine cannot build (it takes a dense slot for its MoE).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.serve_step import generate as jgenerate  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import ParamDef  # noqa: E402
from repro_torch.serving import ServingEngine, generate  # noqa: E402
from repro_torch.serving import loadgen as tload  # noqa: E402
from repro_torch.serving.serve_step import make_prefill_step  # noqa: E402
from repro_torch.training.train_step import value_and_grad  # noqa: E402
from repro_torch.training.tree import tree_leaves  # noqa: E402

RTOL = 1e-5
BF16_RTOL = 2.0 ** -5
NEW_FAMILIES = ["rwkv6-3b", "jamba-1.5-large-398b", "llama-3.2-vision-11b",
                "whisper-medium"]


def _err(got, want) -> tuple[float, float]:
    """max|got - want| and the reference's max magnitude."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    return float(np.abs(got - want).max()), float(np.abs(want).max())


def _close(got, want, rtol: float, what: str) -> None:
    err, scale = _err(got, want)
    assert err <= rtol * max(scale, 1e-30), f"{what}: max err {err:.3e} > {rtol:.1e} x {scale:.3e}"


# ------------------------------- mixers -------------------------------------

def _weights(defs: dict, rng) -> dict:
    """numpy weights for a mixer's defs: matrices at 1/sqrt(fan-in), ones
    and zeros perturbed by 0.1, ``mu`` from U(0, 1), ``A_log`` at 0.5
    scale, so every parameter counts."""
    out = {}
    for name, d in defs.items():
        if name == "mu":
            a = rng.uniform(0.0, 1.0, d.shape)
        elif name == "A_log":
            a = 0.5 * rng.standard_normal(d.shape)
        elif d.init in ("ones", "zeros"):
            a = (d.init == "ones") + 0.1 * rng.standard_normal(d.shape)
        elif len(d.shape) >= 2:
            a = rng.standard_normal(d.shape) / math.sqrt(d.shape[-2])
        else:
            a = 0.3 * rng.standard_normal(d.shape)
        out[name] = a.astype(np.float32)
    return out


def _as(tree, dtype: str, lib: str):
    """A numpy tree (dicts, tuples) as jnp or torch arrays of ``dtype``;
    arrays named ``h`` or ``S`` (the scans' states) stay f32."""
    def one(a, name=""):
        dt = "float32" if name in ("h", "S") else dtype
        if lib == "jax":
            return jnp.asarray(a).astype(getattr(jnp, dt))
        return torch.from_numpy(np.asarray(a)).to(getattr(torch, dt))

    if isinstance(tree, dict):
        return {k: one(v, k) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(one(v, n) for v, n in zip(tree, ("conv", "h")))
    return one(tree)


def _mixer_case(kind: str, stateful: bool, seed: int = 0):
    """(cfg_j, cfg_t, weights, x, state or extra input) as numpy."""
    rng = np.random.default_rng(seed)
    B, S = 2, 9
    arch = {"mamba": "jamba-1.5-large-398b", "rwkv": "rwkv6-3b", "channel_mix": "rwkv6-3b",
            "cross_vlm": "llama-3.2-vision-11b", "cross_encdec": "whisper-medium"}[kind]
    cj, ct = jcfg.get(arch).reduced(), tcfg.get(arch).reduced()
    d = ct.d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    if kind == "mamba":
        w = _weights(tssm.mamba_defs(ct), rng)
        di, _, ds, dc = tssm._dims(ct)
        extra = ((rng.standard_normal((B, dc - 1, di)).astype(np.float32),
                  0.5 * rng.standard_normal((B, di, ds)).astype(np.float32))
                 if stateful else None)
    elif kind == "rwkv":
        w = _weights(trwkv.rwkv_defs(ct), rng)
        hs = ct.rwkv_head_size
        extra = ({"last_x": rng.standard_normal((B, d)).astype(np.float32),
                  "last_cm": rng.standard_normal((B, d)).astype(np.float32),
                  "S": 0.5 * rng.standard_normal((B, d // hs, hs, hs)).astype(np.float32)}
                 if stateful else None)
    elif kind == "channel_mix":
        w = _weights(trwkv.channel_mix_defs(ct), rng)
        extra = rng.standard_normal((B, d)).astype(np.float32) if stateful else None
    else:
        w = _weights(tattn.attn_defs(ct, cross=True), rng)
        M = ct.vision_tokens if kind == "cross_vlm" else ct.encoder_seq
        extra = rng.standard_normal((B, M, d)).astype(np.float32)
    return cj, ct, w, x, extra


def _run_mixer(kind, stateful, lib, cfg, w, x, extra):
    """(output, new state or None) of the mixer in ``lib``'s package."""
    mods = {"jax": (jssm, jrwkv, jattn), "torch": (tssm, trwkv, tattn)}[lib]
    ssm, rwkv, attn = mods
    if kind == "mamba":
        return ssm.mamba_apply(x, w, cfg, state=extra)
    if kind == "rwkv":
        return rwkv.rwkv_apply(x, w, cfg, state=extra)
    if kind == "channel_mix":
        return rwkv.channel_mix_apply(x, w, cfg, last=extra)
    if not stateful:
        return attn.cross_attention(x, extra, w, cfg)
    # with the memory's k/v given (a decode step): made by this package
    _, kv = attn.cross_attention(x, extra, w, cfg)
    return attn.cross_attention(x, None, w, cfg, mem_kv=kv)


def _leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(tree)
    return [tree]


MIXERS = ["mamba", "rwkv", "channel_mix", "cross_vlm", "cross_encdec"]


@pytest.mark.parametrize("stateful", [False, True], ids=["stateless", "state"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", MIXERS)
def test_mixer_matches_reference(kind, dtype, stateful):
    cj, ct, w, x, extra = _mixer_case(kind, stateful)
    want = jax.jit(lambda w_, x_, e_: _run_mixer(kind, stateful, "jax", cj, w_, x_, e_))(
        _as(w, dtype, "jax"), _as(x, dtype, "jax"), None if extra is None
        else _as(extra, dtype, "jax"))
    got = _run_mixer(kind, stateful, "torch", ct, _as(w, dtype, "torch"),
                     _as(x, dtype, "torch"),
                     None if extra is None else _as(extra, dtype, "torch"))
    rtol = RTOL if dtype == "float32" else BF16_RTOL
    assert str(got[0].dtype).removeprefix("torch.") == str(want[0].dtype)
    _close(got[0], want[0], rtol, f"{kind} out")
    g_state, w_state = _leaves(got[1]), _leaves(want[1])
    assert len(g_state) == len(w_state)
    for i, (g, wnt) in enumerate(zip(g_state, w_state)):
        assert str(g.dtype).removeprefix("torch.") == str(wnt.dtype), (kind, i)
        _close(g, wnt, rtol, f"{kind} state leaf {i}")


# ------------------------------- models -------------------------------------

PERTURBED = ("norm", "['b", "_b']", "_bias']", "['A_log']", "['D']", "['decay_base']",
             "['ln_out']", "['u']")


@functools.lru_cache(maxsize=None)
def _pair(name: str, cm_mu: float | None = None):
    """The JAX model, its parameters (perturbed as ``test_torch_models``
    does), the port's model and the same parameters carried across.
    ``cm_mu`` sets every channel-mix ``mu``."""
    jm = jbuild(jcfg.get(name).reduced())
    rng = np.random.default_rng(1)

    def perturb(path, a):
        a = np.asarray(a)
        key = jax.tree_util.keystr(path)
        if "['mu']" in key:
            if cm_mu is not None and "['ffn']" in key:
                return np.full_like(a, cm_mu)
            return rng.uniform(0.0, 1.0, a.shape).astype(a.dtype)
        if any(k in key for k in PERTURBED):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, jm.init(jax.random.key(0)))
    tm = tbuild(tcfg.get(name).reduced(), "cpu")
    return jm, tree, tm, params_from_numpy(tm, tree)


def _inputs(cfg, B=2, S=12, seed=2) -> tuple[np.ndarray, dict]:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        return toks, {"vision": rng.standard_normal((B, cfg.vision_tokens, cfg.d_model))
                      .astype(np.float32)}
    if cfg.family == "encdec":
        return toks, {"frames": rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
                      .astype(np.float32)}
    return toks, {}


def _decode_trace(model, params, toks, extras, lib: str, cache_dtype, fed):
    """Prefill the first 8 tokens, then feed ``fed`` one token a step: the
    last logits of each, and the cache after the prefill."""
    if lib == "jax":
        ex = {k: jnp.asarray(v) for k, v in extras.items()}
        logits, cache = jax.jit(lambda p, t, e: model.prefill(
            p, t, extras=e, max_seq=24, cache_dtype=cache_dtype))(params, jnp.asarray(toks[:, :8]),
                                                                   ex)
        step = jax.jit(model.decode_step)
        wrap = jnp.asarray
    else:
        ex = {k: torch.from_numpy(v) for k, v in extras.items()}
        logits, cache = model.prefill(params, torch.from_numpy(toks[:, :8]), extras=ex,
                                      max_seq=24, cache_dtype=cache_dtype)
        step = model.decode_step
        wrap = torch.from_numpy
    prefilled = {jax.tree_util.keystr(p): str(a.dtype).removeprefix("torch.")
                 for p, a in jax.tree_util.tree_leaves_with_path(cache["groups"])}
    out = [logits[:, -1]]
    for i in range(fed.shape[1]):
        logits, cache = step(params, cache, wrap(fed[:, i:i + 1]))
        out.append(logits[:, -1])
    return out, prefilled


def test_rwkv_decode_is_its_forward_where_the_references_is_not():
    """The channel mix's ``mu`` at 0.5 makes its token shift count: the
    reference's decode then departs from its own forward by more than
    1e-4 of max|logit|; the port's decode stays within 1e-5 of its
    forward (and of the reference's)."""
    jm, tree, tm, tp = _pair("rwkv6-3b", cm_mu=0.5)
    toks, _ = _inputs(tm.cfg)
    jp = jax.tree.map(jnp.asarray, tree)
    want = np.asarray(jax.jit(lambda p, t: jm.logits(p, jm.forward(p, t)[0]))(
        jp, jnp.asarray(toks)))
    scale = float(np.abs(want).max())
    ref_steps, _ = _decode_trace(jm, jp, toks, {}, "jax", jnp.float32, toks[:, 8:])
    port_steps, _ = _decode_trace(tm, tp, toks, {}, "torch", torch.float32, toks[:, 8:])
    ref_err = max(float(np.abs(np.asarray(g) - want[:, 7 + i]).max())
                  for i, g in enumerate(ref_steps[:4]))
    port_err = max(float(np.abs(g.numpy() - want[:, 7 + i]).max())
                   for i, g in enumerate(port_steps[:4]))
    assert ref_err > 1e-4 * scale, (ref_err, scale)
    assert port_err <= 1e-5 * scale, (port_err, scale)
    x, _, _ = tm.forward(tp, torch.from_numpy(toks))
    own = tm.logits(tp, x)
    for i, g in enumerate(port_steps[:4]):
        _close(g, own[:, 7 + i].numpy(), 1e-5, f"port decode step {i} vs its forward")


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_bf16_cache_dtypes_and_decode_match_reference(name):
    """A bf16 cache: after the prefill every leaf is in the reference's
    dtype (mamba's conv and h, rwkv's states and the memories' k/v leave
    bf16), and the decode steps give the reference's logits (the rwkv
    family's against the reference's forward)."""
    jm, tree, tm, tp = _pair(name)
    toks, extras = _inputs(tm.cfg)
    jp = jax.tree.map(jnp.asarray, tree)
    port_steps, got = _decode_trace(tm, tp, toks, extras, "torch", torch.bfloat16, toks[:, 8:11])
    ref_steps, want = _decode_trace(jm, jp, toks, extras, "jax", jnp.bfloat16, toks[:, 8:11])
    assert got == want
    assert "float32" in got.values(), "some state leaves the bf16 cache"
    if tm.cfg.rwkv:
        full = np.asarray(jax.jit(lambda p, t: jm.logits(p, jm.forward(p, t)[0]))(
            jp, jnp.asarray(toks[:, :11])))
        ref_steps = [full[:, 7 + i] for i in range(4)]
        # the bf16 cache holds the attention-free state in f32: no bf16 rounding
        rtol = RTOL
    else:
        # the same bf16 k/v cache in both, read by f32 queries: f32 sums
        rtol = RTOL
    for i, (g, w) in enumerate(zip(port_steps, ref_steps)):
        _close(g, w, rtol, f"{name} bf16-cache step {i}")


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_loss_and_grads_match_reference(name, remat):
    """Each leaf within ``RTOL`` of its largest magnitude; but an attention
    key bias's gradient is 0 in exact arithmetic (a shift shared by every
    key leaves the softmax as it is), so both packages give rounding
    noise there (about 1e-13): those leaves are held within ``RTOL`` of
    the largest gradient of the tree."""
    jm, tree, tm, tp = _pair(name)
    toks, extras = _inputs(tm.cfg, S=10)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1), **extras}
    jl, jg = _jax_value_and_grad(name, jm, tree, batch)
    model = tm if remat else tbuild(dataclasses.replace(tm.cfg, remat=False), "cpu")
    assert model.cfg.remat == remat
    tl, tg = value_and_grad(model, tp, batch)
    assert abs(float(tl) - float(jl)) <= RTOL * abs(float(jl)), (float(tl), float(jl))
    want = jax.tree_util.tree_leaves_with_path(jg)
    got = tree_leaves(tg)
    assert len(got) == len(want)
    largest = max(float(jnp.abs(w).max()) for _, w in want)
    for (path, w), g in zip(want, got):
        key = jax.tree_util.keystr(path)
        if key.endswith("['bk']"):
            err, _ = _err(g, w)
            assert err <= RTOL * largest, (key, err, largest)
        else:
            _close(g, w, RTOL, f"{name} grad {key}")


_JAX_GRADS: dict = {}


def _jax_value_and_grad(name, jm, tree, batch):
    """The reference's (loss, grads), computed once a family: the port
    with remat on and with it off is held to the same values."""
    if name not in _JAX_GRADS:
        _JAX_GRADS[name] = jax.jit(jax.value_and_grad(jm.loss))(
            jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    return _JAX_GRADS[name]


@pytest.mark.parametrize("name", ["llama-3.2-vision-11b", "whisper-medium"])
def test_generate_with_extras_matches_reference(name):
    jm, tree, tm, tp = _pair(name)
    toks, extras = _inputs(tm.cfg, S=8, seed=5)
    want = jgenerate(jm, jax.tree.map(jnp.asarray, tree), jnp.asarray(toks), steps=5,
                     max_seq=16, extras={k: jnp.asarray(v) for k, v in extras.items()},
                     cache_dtype=jnp.float32)
    ex = {k: torch.from_numpy(v) for k, v in extras.items()}
    got = generate(tm, tp, torch.from_numpy(toks), steps=5, max_seq=16, extras=ex,
                   cache_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the prefill step takes the memory from its batch
    logits, cache = make_prefill_step(tm, 16, torch.float32)(
        tp, {"tokens": torch.from_numpy(toks), **ex})
    assert cache["pos"] == 8
    assert torch.equal(torch.argmax(logits[:, -1], -1).int(), got[:, 0])


def test_serving_engine_serves_jamba_where_the_reference_cannot():
    """The reduced jamba (a dense SwiGLU slot first, MoE on every other
    slot) served with the coded expert jobs, worker 0 dead.  The
    reference's engine takes the first slot whose FFN has a ``w_gate`` as
    its MoE and fails on the dense one; the port's takes the first with a
    router.  Every request completes, with a straggler recovery, and gives
    the reference's greedy tokens for its prompt (``generate`` on the coded
    model, f32 cache)."""
    cfg_j = jcfg.get("jamba-1.5-large-398b").reduced()
    cfg_t = tcfg.get("jamba-1.5-large-398b").reduced()
    kw = dict(coded=True, num_workers=6, source="sim", unit_block_time=1e-3,
              max_batch=2, dead_workers=(0,), max_seq=16)
    with pytest.raises(KeyError, match="router"):
        JaxEngine(cfg_j, **kw)
    jm = jbuild(cfg_j.with_opts(["coded_moe"]))
    jp = jm.init(jax.random.key(0))
    model = tbuild(cfg_t, "cpu")
    params = params_from_numpy(model, jax.tree.map(np.asarray, jp))
    trace = tload.poisson_trace([tload.TenantSpec("a", rate=60.0, prompt_len=5,
                                                  max_new_tokens=3)],
                                horizon=0.1, seed=9, max_requests=2)
    with ServingEngine(cfg_t, device="cpu", params=params, **kw) as eng:
        got = eng.run(trace)
    s = got.summary()
    assert s["completed"] == s["requests"] == 2 and s["straggler_recoveries"] >= 1
    for r in got.requests:
        prompt = np.random.default_rng(r.prompt_seed).integers(
            0, cfg_t.vocab_size, size=(1, r.prompt_len)).astype(np.int32)
        want = jgenerate(jm, jp, jnp.asarray(prompt), steps=r.max_new_tokens, max_seq=16,
                         cache_dtype=jnp.float32)
        assert r.tokens == np.asarray(want)[0].tolist(), r.rid


def test_param_defs_follow_the_reference_inits():
    """Every new leaf's init rule is the reference's (``A_log`` zeros, ``D``
    ones, the rwkv ``mu``/``u``/decay small normal)."""
    for name in NEW_FAMILIES:
        jdefs = jbuild(jcfg.get(name).reduced()).param_defs()
        tdefs = tbuild(tcfg.get(name).reduced(), "cpu").param_defs()
        want = {jax.tree_util.keystr(p): (tuple(d.shape), d.init) for p, d in
                jax.tree_util.tree_leaves_with_path(
                    jdefs, is_leaf=lambda v: hasattr(v, "init") and hasattr(v, "shape"))}
        got = {jax.tree_util.keystr(p): (tuple(d.shape), d.init) for p, d in
               jax.tree_util.tree_leaves_with_path(
                   tdefs, is_leaf=lambda v: isinstance(v, ParamDef))}
        assert got == want, name
