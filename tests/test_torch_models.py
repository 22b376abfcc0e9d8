"""The port's configs and model layers against the JAX package's, on the CPU.

* the two config registries hold the same names, fields and derived sizes;
* the layers (norms in f32 and bf16, activations, RoPE, sinusoidal
  positions) and the ``ParamDef`` init rule;
* every family at its ``reduced()`` size (dense, MoE, and the rwkv,
  mamba hybrid, vision cross-attention and encoder-decoder ones with
  their ``vision`` / ``frames``), on the JAX package's own parameters
  carried across by ``models.convert`` (biases, norm scales and the
  mixers' other zero or one inits perturbed, the rwkv token-shift ``mu``s
  drawn from U(0, 1), so they count): ``forward`` hidden states and
  ``logits`` within 1e-5 of the reference's largest magnitude (f32 sums of
  at most a few hundred terms round near 1e-7 of it), and prefill then
  greedy decode giving the reference's logits and tokens -- also with
  ``opt_coded_moe``, ``opt_moe_local_dispatch`` and ``opt_onehot_cache``
  each on, and with RoPE off (sinusoidal positions).  The rwkv family's
  decode is held to the reference's forward: the reference's own decode
  departs from it (``test_torch_mixers.py``);
* the MoE dispatch at qwen3's routing (128 experts top-8, capacity factor
  1.25: a 32-token batch keeps 2 of each expert's slots and drops the
  rest) and on exact ties in the router;
* the expert code's decode matrix, survivor-rebound, within 1e-6 of the
  reference's, and ``DecodingError`` on a rank loss.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.core.decoder import DecodingError  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.layers import ParamDef  # noqa: E402

FAMILIES = ["qwen3-moe-30b-a3b", "dbrx-132b", "qwen2-7b", "internlm2-1.8b",
            "starcoder2-7b", "command-r-35b", "rwkv6-3b", "jamba-1.5-large-398b",
            "whisper-medium", "llama-3.2-vision-11b"]
RTOL = 1e-5  # of the reference's largest magnitude
# leaves whose init is all zeros or ones (or tiny), perturbed so they count
PERTURBED = ("norm", "['b", "_b']", "_bias']", "['A_log']", "['D']", "['decay_base']",
             "['ln_out']", "['u']")


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, dtype=np.float32)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    tol = RTOL * float(np.abs(want).max())
    assert err <= tol, f"{what}: max err {err:.3e} > {tol:.3e}"


# ------------------------------ configs -------------------------------------

def test_registries_hold_the_same_configs():
    assert sorted(tcfg.ARCHS) == sorted(jcfg.ARCHS)
    for name in jcfg.ARCHS:
        j, t = jcfg.get(name), tcfg.get(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        for c, r in ((t, j), (t.reduced(), j.reduced())):
            assert dataclasses.asdict(c) == dataclasses.asdict(r), name
            assert (c.hd, c.group_size, c.num_groups, c.layer_plan(),
                    c.params_count(), c.active_params_count()) == (
                r.hd, r.group_size, r.num_groups, r.layer_plan(),
                r.params_count(), r.active_params_count()), name
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get("no-such-arch")


def test_config_options_follow_the_reference():
    t, j = tcfg.get("qwen3-moe-30b-a3b"), jcfg.get("qwen3-moe-30b-a3b")
    opts = ["coded_moe", "onehot_cache", "moe_local_dispatch"]
    assert dataclasses.asdict(t.with_opts(opts)) == dataclasses.asdict(j.with_opts(opts))
    with pytest.raises(ValueError, match="unknown opt"):
        t.with_opts(["no_such_opt"])
    coded = t.with_coded(backend="block_sparse")
    assert coded.coded_backend == coded.coded.backend == "block_sparse"
    assert dataclasses.replace(t, coded_backend="block_sparse").coded.backend == "block_sparse"
    with pytest.raises(ValueError, match="coded_backend"):
        dataclasses.replace(t, coded_backend="no_such_backend")


# ------------------------------- layers -------------------------------------

def _layer_cases():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    pos = np.arange(3, 8)
    return {
        "rmsnorm": (lambda m, a, s: m.rmsnorm(a, s), x, scale),
        "layernorm": (lambda m, a, s: m.layernorm(a, s), x, scale),
        "silu": (lambda m, a, s: m.activation(a, "silu"), x, None),
        "gelu": (lambda m, a, s: m.activation(a, "gelu"), x, None),
        "relu_sq": (lambda m, a, s: m.activation(a, "relu_sq"), x, None),
        "rope": (lambda m, a, s: m.apply_rope(a, s, 10_000.0), x, pos),
        "rope_theta": (lambda m, a, s: m.apply_rope(a, s, 1e6), x, pos),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(_layer_cases()))
def test_layer_matches_reference(name, dtype):
    fn, x, extra = _layer_cases()[name]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    want = fn(jlayers, jx, None if extra is None else jnp.asarray(extra))
    got = fn(tlayers, tx, None if extra is None else torch.from_numpy(extra))
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    # bf16 results may differ by one bf16 rounding of the same f32 value
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert err <= tol * max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))


def test_sinusoidal_positions_and_rope_freqs():
    np.testing.assert_allclose(tlayers.sinusoidal_positions(37, 24).numpy(),
                               np.asarray(jlayers.sinusoidal_positions(37, 24)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tlayers.rope_freqs(128, 1e6).numpy(),
                               np.asarray(jlayers.rope_freqs(128, 1e6)), rtol=1e-6)


def test_param_init_rule():
    gen = torch.Generator().manual_seed(0)
    cpu = torch.device("cpu")
    assert torch.equal(ParamDef((3, 4), "zeros").materialize(gen, torch.float32, cpu),
                       torch.zeros(3, 4))
    assert torch.equal(ParamDef((5,), "ones").materialize(gen, torch.bfloat16, cpu),
                       torch.ones(5, dtype=torch.bfloat16))
    # scale 0.02 (0.006 small_normal), capped at 1/sqrt(fan-in = dim -2)
    for shape, init, scale in (((64, 4096), "normal", 0.02),
                               ((4, 10_000, 256), "normal", 0.01),
                               ((2048, 128), "small_normal", 0.006)):
        w = ParamDef(shape, init).materialize(gen, torch.float32, cpu)
        assert abs(float(w.std()) / scale - 1) < 0.02, (shape, init)
    a = ParamDef((8, 8)).materialize(torch.Generator().manual_seed(3), torch.float32, cpu)
    b = ParamDef((8, 8)).materialize(torch.Generator().manual_seed(3), torch.float32, cpu)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", FAMILIES)
def test_param_tree_matches_reference(name):
    shapes = jbuild(jcfg.get(name).reduced()).shapes()
    want = {jax.tree_util.keystr(p): s.shape
            for p, s in jax.tree_util.tree_leaves_with_path(shapes)}
    params = tbuild(tcfg.get(name).reduced(), "cpu").init(seed=1)
    got = {jax.tree_util.keystr(p): tuple(t.shape)
           for p, t in jax.tree_util.tree_leaves_with_path(params)}
    assert got == want


@pytest.mark.parametrize("name", ["whisper-medium", "llama-3.2-vision-11b"])
def test_memory_families_without_their_inputs_fail_as_the_reference(name):
    """The vlm and encdec families attend over a memory: without ``vision``
    or ``frames`` there is none to project, and both packages raise
    ``ValueError`` (the reference's from its einsum)."""
    jm, jp, tm, tp = _pair(name)
    toks = _tokens(tm.cfg, S=4)
    with pytest.raises(ValueError):
        jm.forward(jp, jnp.asarray(toks))
    with pytest.raises(ValueError, match="needs a memory"):
        tm.forward(tp, torch.from_numpy(toks))


# ------------------------------- models -------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(name: str, opts: tuple = (), no_rope: bool = False):
    """The JAX model and the port's, on the same parameters: the reference's
    init with every norm scale and bias perturbed, carried across."""
    jc, tc = jcfg.get(name).reduced(), tcfg.get(name).reduced()
    if opts:
        jc, tc = jc.with_opts(opts), tc.with_opts(opts)
    if no_rope:
        jc, tc = (dataclasses.replace(c, use_rope=False) for c in (jc, tc))
    jm = jbuild(jc)
    rng = np.random.default_rng(1)

    def perturb(path, a):
        a = np.asarray(a)
        key = jax.tree_util.keystr(path)
        if "['mu']" in key:  # the rwkv token shifts
            return rng.uniform(0.0, 1.0, a.shape).astype(a.dtype)
        if any(k in key for k in PERTURBED):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, jm.init(jax.random.key(0)))
    tm = tbuild(tc, "cpu")
    return jm, jax.tree.map(jnp.asarray, tree), tm, params_from_numpy(tm, tree)


def _tokens(cfg, B=2, S=12, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _extras(cfg, B=2, seed=3) -> dict:
    """The vlm family's image tokens or the encdec family's frames, as
    numpy (none for the other families)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"vision": rng.standard_normal((B, cfg.vision_tokens, cfg.d_model))
                .astype(np.float32)}
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
                .astype(np.float32)}
    return {}


def _jax_trace(model, params, toks, steps, extras, decode=True):
    """The reference's forward over ``toks`` (hidden, aux, logits), then its
    prefill of the first 8 tokens and ``steps`` greedy decode steps: every
    step's logits and the tokens (with ``decode`` off, the prefill's
    alone).  Two compilations in all."""
    @jax.jit
    def forward_and_prefill(p, t, ex):
        x, aux, _ = model.forward(p, t, extras=ex)
        return (x, aux, model.logits(p, x)), model.prefill(
            p, t[:, :8], extras=ex, max_seq=24, cache_dtype=jnp.float32)

    ex = {k: jnp.asarray(v) for k, v in extras.items()}
    full, (logits, cache) = forward_and_prefill(params, jnp.asarray(toks), ex)
    out, toks_out = [logits], []
    if not decode:
        return full, out, None
    step = jax.jit(model.decode_step)
    for _ in range(steps):
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        toks_out.append(np.asarray(tok))
        logits, cache = step(params, cache, tok)
        out.append(logits)
    return full, out, np.concatenate(toks_out, 1)


def _torch_trace(model, params, toks, steps, extras):
    ex = {k: torch.from_numpy(v) for k, v in extras.items()}
    x, aux, _ = model.forward(params, torch.from_numpy(toks), extras=ex)
    logits, cache = model.prefill(params, torch.from_numpy(toks[:, :8]), extras=ex,
                                  max_seq=24, cache_dtype=torch.float32)
    out, toks_out = [logits], []
    for _ in range(steps):
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        toks_out.append(tok.numpy())
        logits, cache = model.decode_step(params, cache, tok)
        out.append(logits)
    return (x, aux, model.logits(params, x)), out, np.concatenate(toks_out, 1)


CASES = [(name, ()) for name in FAMILIES] + [
    ("qwen3-moe-30b-a3b", ("coded_moe",)),
    ("qwen3-moe-30b-a3b", ("moe_local_dispatch",)),
    ("qwen3-moe-30b-a3b", ("onehot_cache",)),
    ("qwen3-moe-30b-a3b", ("coded_moe", "moe_local_dispatch")),
    ("dbrx-132b", ("coded_moe",)),
    ("starcoder2-7b", ("onehot_cache",)),
    ("internlm2-1.8b", "no_rope"),
]


@pytest.mark.parametrize("name,opts", CASES, ids=lambda v: "-".join(v) if isinstance(v, tuple) else v)
def test_model_matches_reference(name, opts):
    no_rope = opts == "no_rope"
    opts = () if no_rope else opts
    jm, jp, tm, tp = _pair(name, opts, no_rope)
    toks, extras = _tokens(tm.cfg), _extras(tm.cfg)
    # the reference's rwkv decode is not its forward (``last_cm``): the
    # port's decode is held to the reference's forward instead
    by_forward = tm.cfg.rwkv
    (jx, jaux, jlogits), jlog, jtok = _jax_trace(jm, jp, toks, 4, extras,
                                                 decode=not by_forward)
    (tx, taux, tlogits), tlog, ttok = _torch_trace(tm, tp, toks, 4, extras)
    _close(tx, jx, "hidden")
    _close(tlogits, jlogits, "logits")
    _close(taux, jaux, "aux")
    if by_forward:
        fed = np.concatenate([toks[:, :8], ttok], 1)
        want = np.asarray(jax.jit(lambda p, t: jm.logits(p, jm.forward(p, t)[0]))(
            jp, jnp.asarray(fed)))
        jlog = [want[:, 7 + i][:, None] for i in range(5)]
        jtok = want[:, 7:11].argmax(-1)
    for i, (g, w) in enumerate(zip(tlog, jlog)):
        _close(g, w, f"decode step {i} logits")
    np.testing.assert_array_equal(ttok, jtok)

    # prefill + decode == one forward over the same tokens (reduced() is
    # dropless, so the two route alike)
    fed = np.concatenate([toks[:, :8], ttok[:, :3]], 1)
    ex = {k: torch.from_numpy(v) for k, v in extras.items()}
    x_full, _, _ = tm.forward(tp, torch.from_numpy(fed), extras=ex)
    full = tm.logits(tp, x_full).numpy()
    for i in range(4):
        _close(tlog[i][:, -1], full[:, 7 + i], f"cached step {i} vs forward")


def test_local_dispatch_runs_uncoded_as_the_reference_does():
    """The reference's ``moe_apply`` takes ``moe_apply_local`` before it
    reads ``opt_coded_moe``: with both on, the model runs uncoded."""
    _, _, tm, tp = _pair("qwen3-moe-30b-a3b", ("coded_moe", "moe_local_dispatch"))
    _, _, tl, tpl = _pair("qwen3-moe-30b-a3b", ("moe_local_dispatch",))
    toks = torch.from_numpy(_tokens(tm.cfg))
    assert torch.equal(tm.forward(tp, toks)[0], tl.forward(tpl, toks)[0])


# -------------------------------- MoE ---------------------------------------

def _moe_case(E, k, d, ff, T, cf, seed=0, tie=False):
    cfg_j = dataclasses.replace(
        jcfg.get("qwen3-moe-30b-a3b"), d_model=d,
        moe=jcfg.base.MoEConfig(num_experts=E, top_k=k, d_ff=ff, capacity_factor=cf))
    cfg_t = dataclasses.replace(
        tcfg.get("qwen3-moe-30b-a3b"), d_model=d,
        moe=tcfg.base.MoEConfig(num_experts=E, top_k=k, d_ff=ff, capacity_factor=cf))
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, E)).astype(np.float32),
         "w_gate": 0.2 * rng.standard_normal((E, d, ff)).astype(np.float32),
         "w_up": 0.2 * rng.standard_normal((E, d, ff)).astype(np.float32),
         "w_down": 0.2 * rng.standard_normal((E, ff, d)).astype(np.float32)}
    if tie:  # experts 1 and 2 route alike: equal probabilities everywhere
        p["router"][:, 2] = p["router"][:, 1]
    x = rng.standard_normal((1, T, d)).astype(np.float32)
    want, aux_want = jax.jit(lambda x_, p_: jmoe.moe_apply(x_, p_, cfg_j))(
        jnp.asarray(x), {k_: jnp.asarray(v) for k_, v in p.items()})
    got, aux = tmoe.moe_apply(torch.from_numpy(x),
                              {k_: torch.from_numpy(v) for k_, v in p.items()}, cfg_t)
    return p, x, got, aux, want, aux_want


def test_moe_drops_past_capacity_as_the_reference():
    """qwen3's routing: 128 experts top-8 at capacity factor 1.25 keep
    int(32 * 8 * 1.25 // 128) = 2 slots an expert for 32 tokens."""
    p, x, got, aux, want, aux_want = _moe_case(E=128, k=8, d=32, ff=8, T=32, cf=1.25)
    probs = torch.softmax(torch.from_numpy(x[0] @ p["router"]), -1)
    ids = torch.argsort(probs, dim=-1, descending=True, stable=True)[:, :8]
    counts = torch.bincount(ids.reshape(-1), minlength=128)
    assert int(counts.max()) > 2, "the case must overflow an expert's 2 slots"
    _close(got, want, "moe out")
    _close(aux, aux_want, "aux")


def test_moe_breaks_router_ties_by_lower_index():
    p, x, got, aux, want, aux_want = _moe_case(E=4, k=1, d=16, ff=8, T=12, cf=4.0,
                                               tie=True)
    probs = x[0] @ p["router"]
    assert (probs.argmax(-1) == 1).any(), "the case must route to the tied pair"
    _close(got, want, "moe out")


@pytest.mark.parametrize("E", [4, 16])
@pytest.mark.parametrize("dead", [(), (0,), (1, 3)])
def test_coded_moe_decode_matrix_matches_reference(E, dead):
    jc = dataclasses.replace(jcfg.get("dbrx-132b"),
                             moe=dataclasses.replace(jcfg.get("dbrx-132b").moe, num_experts=E))
    tc = dataclasses.replace(tcfg.get("dbrx-132b"),
                             moe=dataclasses.replace(tcfg.get("dbrx-132b").moe, num_experts=E))
    N = tmoe.coded_moe_num_workers(tc)
    assert N == jmoe.coded_moe_num_workers(jc) == E + 2
    surv = None
    if dead:
        surv = np.ones(N, dtype=bool)
        surv[list(dead)] = False
    try:
        want = jmoe.coded_moe_decode_matrix(jc, surv)
    except ValueError as e:  # the reference's DecodingError
        with pytest.raises(DecodingError):
            tmoe.coded_moe_decode_matrix(tc, surv)
        assert "rank" in str(e)
        return
    got = tmoe.coded_moe_decode_matrix(tc, surv)
    assert got.shape == (E, N) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_coded_moe_decode_matrix_raises_on_a_rank_loss():
    tc = tcfg.get("qwen3-moe-30b-a3b").reduced()
    surv = np.zeros(tmoe.coded_moe_num_workers(tc), dtype=bool)
    surv[:3] = True  # 3 survivors for 4 experts
    with pytest.raises(DecodingError):
        tmoe.coded_moe_decode_matrix(tc, surv)


def test_coded_decode_context_reroutes_the_expert_product():
    """Under ``coded_moe_decode`` a survivor-rebound D decodes the products
    without the dead workers' rows, as the reference's does."""
    tc = tcfg.get("qwen3-moe-30b-a3b").reduced().with_opts(["coded_moe"])
    jc = jcfg.get("qwen3-moe-30b-a3b").reduced().with_opts(["coded_moe"])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 3, 16)).astype(np.float32)
    W = rng.standard_normal((4, 16, 8)).astype(np.float32)
    surv = np.ones(6, dtype=bool)
    surv[0] = False
    D = tmoe.coded_moe_decode_matrix(tc, surv)
    with tmoe.coded_moe_decode(torch.from_numpy(D)):
        got = tmoe._coded_expert_mm(torch.from_numpy(x), torch.from_numpy(W), tc)
    with jmoe.coded_moe_decode(jnp.asarray(jmoe.coded_moe_decode_matrix(jc, surv))):
        want = jmoe._coded_expert_mm(jnp.asarray(x), jnp.asarray(W), "ecd,edf->ecf", jc)
    _close(got, want, "coded expert product")
    _close(got, np.matmul(x, W), "coded vs plain")


# ------------------------------- convert ------------------------------------

def test_convert_refuses_a_tree_that_is_not_the_model():
    _, jp, tm, _ = _pair("internlm2-1.8b")
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, head=tree["head"][:, :5])
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tm, bad)
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(tm, {k: v for k, v in tree.items() if k != "final_norm"})


def test_kv_cache_refuses_to_run_past_its_end():
    tm = tbuild(tcfg.get("internlm2-1.8b").reduced(), "cpu")
    params = tm.init()
    with pytest.raises(ValueError, match="KV cache holds 4"):
        tm.prefill(params, torch.zeros(1, 6, dtype=torch.int32), max_seq=4)
    assert tattn.NEG_INF == jattn.NEG_INF
