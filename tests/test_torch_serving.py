"""The port's serving path against the JAX package's, on the CPU.

* the scheduler and the load generator, bit for bit on the same traces:
  admissions (FIFO within a tenant, round-robin across tenants), arrival
  times and prompt seeds, percentiles and ``summary()``;
* ``generate``: the reference's greedy tokens on the same parameters, and
  temperature sampling that follows its ``torch.Generator``;
* ``cached_decode_step``: one step per (model, temperature), released with
  the model;
* ``ServingEngine`` on the reference's parameters over ``JobMux("sim")``:
  the reference's tokens, completions, errors and straggler recoveries,
  coded and uncoded, healthy and with worker 0 dead; over ``"live"``
  threads, the same tokens; and a survivor set that loses rank refused
  before any step.
"""

from __future__ import annotations

import gc
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfg  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.serving import loadgen as jload  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro.serving.serve_step import generate as jgenerate  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.core.decoder import DecodingError  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import loadgen as tload  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.serve_step import (cached_decode_step, generate,  # noqa: E402
                                           make_prefill_step)

REQ_FIELDS = ("rid", "tenant", "arrival_time", "prompt_len", "max_new_tokens",
              "prompt_seed", "slo")


def _fields(reqs) -> list:
    return [tuple(getattr(r, f) if f != "slo" else (r.slo.ttft, r.slo.per_token)
                  for f in REQ_FIELDS) for r in reqs]


def _tenants(mod, n=3):
    return [mod.TenantSpec(f"t{i}", rate=5.0 + 7 * i, prompt_len=4 + i,
                           max_new_tokens=2 + i, weight=1.0 + i,
                           slo=mod.SLO(ttft=0.5 * (i + 1), per_token=0.1))
            for i in range(n)]


# ------------------------------ loadgen -------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123])
def test_poisson_trace_matches_reference(seed):
    for n, horizon, cap in ((1, 2.0, None), (3, 1.5, None), (3, 3.0, 11)):
        got = tload.poisson_trace(_tenants(tload, n), horizon=horizon, seed=seed,
                                  max_requests=cap)
        want = jload.poisson_trace(_tenants(jload, n), horizon=horizon, seed=seed,
                                   max_requests=cap)
        assert _fields(got) == _fields(want)
    with pytest.raises(ValueError, match="horizon"):
        tload.poisson_trace(_tenants(tload), horizon=0.0)


@pytest.mark.parametrize("concurrency,total", [(1, 4), (4, 9), (5, 5)])
def test_closed_loop_matches_reference(concurrency, total):
    runs = []
    for mod in (tload, jload):
        load = mod.ClosedLoopLoad(_tenants(mod), concurrency=concurrency,
                                  total=total, seed=3)
        issued = load.initial()
        i = 0
        while (nxt := load.next_request(issued[i], now=0.1 * i)) is not None:
            issued.append(nxt)
            i += 1
        runs.append(_fields(issued))
    assert runs[0] == runs[1]


# ----------------------------- scheduler ------------------------------------

def _drive(mod, seed: int, max_batch: int) -> list:
    """A random interleaving of submits, admits and retires: the admission
    order and the running set after every step."""
    rng = random.Random(seed)
    b = mod.ContinuousBatcher(max_batch)
    log, k = [], 0
    for step in range(60):
        op = rng.random()
        if op < 0.5:
            b.submit(mod.Request(rid=f"r{k}", tenant=rng.choice("abc"),
                                 arrival_time=float(step), prompt_len=3,
                                 max_new_tokens=2))
            k += 1
        elif op < 0.8:
            log.append(("admit", [r.rid for r in b.admit(float(step))]))
        elif b.running:
            req = b.running[rng.randrange(len(b.running))]
            b.retire(req, float(step))
            log.append(("retire", req.rid, req.finish_time))
        log.append((b.waiting, [r.rid for r in b.running],
                    b.waiting_for("a"), b.waiting_for("zz")))
    return log


@pytest.mark.parametrize("seed", range(4))
def test_batcher_matches_reference(seed):
    assert _drive(tsched, seed, 1 + seed % 3) == _drive(jsched, seed, 1 + seed % 3)
    with pytest.raises(ValueError, match="max_batch"):
        tsched.ContinuousBatcher(0)


def _finished(mod, seed: int) -> list:
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(12):
        r = mod.Request(rid=f"r{i}", tenant="ab"[i % 2], arrival_time=float(i),
                        prompt_len=4, max_new_tokens=3,
                        slo=mod.SLO(ttft=1.0, per_token=0.3))
        if i % 5 == 4:
            r.error = "worker gone"
        else:
            r.first_token_time = i + float(rng.uniform(0, 2))
            r.token_latencies = rng.uniform(0, 0.5, 2).tolist()
            r.tokens = [1, 2, 3]
            r.straggler_recoveries = int(rng.integers(0, 3))
        r.finish_time = i + 3.0
        reqs.append(r)
    return reqs


@pytest.mark.parametrize("seed", range(3))
def test_metrics_match_reference(seed):
    vals = np.random.default_rng(seed).standard_normal(17).tolist()
    for p in (0, 1, 50, 95, 99, 100):
        assert tsched.percentile(vals, p) == jsched.percentile(vals, p)
    summaries = []
    for mod in (tsched, jsched):
        m = mod.ServingMetrics()
        for r in _finished(mod, seed):
            m.record(r)
        summaries.append(m.summary())
    assert summaries[0] == summaries[1]


# ------------------------------ generate ------------------------------------

def _pair(name: str):
    jm = jbuild(jcfg.get(name).reduced())
    jp = jm.init(jax.random.key(0))
    tm = tbuild(tcfg.get(name).reduced(), "cpu")
    return jm, jp, tm, params_from_numpy(tm, jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("name", ["internlm2-1.8b", "qwen3-moe-30b-a3b"])
def test_generate_greedy_matches_reference(name):
    jm, jp, tm, tp = _pair(name)
    prompt = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, (2, 8)).astype(np.int32)
    want = jgenerate(jm, jp, jnp.asarray(prompt), steps=6, max_seq=16,
                     cache_dtype=jnp.float32)
    got = generate(tm, tp, torch.from_numpy(prompt), steps=6, max_seq=16,
                   cache_dtype=torch.float32)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the prefill step is the model's prefill, and its argmax the first token
    logits, cache = make_prefill_step(tm, 16, torch.float32)(
        tp, {"tokens": torch.from_numpy(prompt)})
    assert cache["pos"] == 8 and logits.shape == (2, 1, tm.cfg.vocab_size)
    assert torch.equal(torch.argmax(logits[:, -1], -1).int(), got[:, 0])
    # the default bf16 cache: f32 queries against it compute in f32 there too
    np.testing.assert_array_equal(
        generate(tm, tp, torch.from_numpy(prompt), steps=4, max_seq=16).numpy(),
        np.asarray(jgenerate(jm, jp, jnp.asarray(prompt), steps=4, max_seq=16)))


def test_temperature_sampling_follows_the_generator():
    tm = tbuild(tcfg.get("internlm2-1.8b").reduced(), "cpu")
    params = tm.init(seed=1)
    prompt = torch.zeros((1, 8), dtype=torch.int32)

    def sample(seed):
        return generate(tm, params, prompt, steps=8, max_seq=20, temperature=2.0,
                        rng=torch.Generator().manual_seed(seed),
                        cache_dtype=torch.float32)

    assert torch.equal(sample(0), sample(0))
    assert not torch.equal(sample(0), sample(1)), "different rng, different text"


def test_decode_step_is_cached_per_model_and_temperature():
    cfg = tcfg.get("internlm2-1.8b").reduced()
    model = tbuild(cfg, "cpu")
    d1 = cached_decode_step(model, 0.0)
    assert cached_decode_step(model, 0.0) is d1
    assert cached_decode_step(model, 1.0) is not d1
    assert cached_decode_step(tbuild(cfg, "cpu"), 0.0) is not d1
    from repro_torch.serving import serve_step
    n = len(serve_step._DECODE_STEPS)
    del model, d1
    gc.collect()
    assert len(serve_step._DECODE_STEPS) < n, "the model's steps outlived it"


# ------------------------------- engine -------------------------------------

def _trace(mod, max_new=3, n=4):
    tenants = [mod.TenantSpec("a", rate=60.0, prompt_len=5, max_new_tokens=max_new),
               mod.TenantSpec("b", rate=40.0, prompt_len=7, max_new_tokens=max_new)]
    return mod.poisson_trace(tenants, horizon=0.1, seed=9, max_requests=n)


def _outcomes(metrics) -> list:
    """Each request's outcome, by rid (the order requests finish in follows
    the wall clock)."""
    return sorted((r.rid, r.tokens, r.completed, r.error, r.straggler_recoveries)
                  for r in metrics.requests)


@pytest.mark.parametrize("dead", [(), (0,)], ids=["healthy", "worker0-dead"])
@pytest.mark.parametrize("coded", [True, False], ids=["coded", "uncoded"])
def test_engine_matches_reference(coded, dead):
    cfg_j = jcfg.get("qwen3-moe-30b-a3b").reduced()
    cfg_t = tcfg.get("qwen3-moe-30b-a3b").reduced()
    kw = dict(coded=coded, num_workers=6, source="sim", unit_block_time=1e-3,
              max_batch=2, dead_workers=dead)
    with JaxEngine(cfg_j, **kw) as ref:
        want = ref.run(_trace(jload))
    model = tbuild(ref.cfg, "cpu")
    params = params_from_numpy(model, jax.tree.map(np.asarray, ref.params))
    with ServingEngine(cfg_t, device="cpu", params=params, **kw) as eng:
        got = eng.run(_trace(tload))
    assert _outcomes(got) == _outcomes(want)
    s = got.summary()
    if coded or not dead:
        assert s["completed"] == s["requests"] == 4
        assert (s["straggler_recoveries"] >= 1) == bool(dead)
    else:  # worker 0 is inside the uncoded footprint: every request fails
        assert s["completed"] == 0 and s["slo_attainment"] == 0.0


def test_engine_live_threads_give_the_sim_tokens():
    cfg = tcfg.get("qwen3-moe-30b-a3b").reduced()
    params = tbuild(cfg, "cpu").init(seed=0)
    runs = {}
    for source in ("sim", "live"):
        with ServingEngine(cfg, device="cpu", params=params, source=source,
                           dead_workers=(0,), max_batch=2, timeout=10.0,
                           unit_block_time=1e-3) as eng:
            eng.warmup([5, 7])
            runs[source] = eng.run(_trace(tload, n=3))
    assert [r.tokens for r in runs["live"].requests] == \
           [r.tokens for r in runs["sim"].requests]
    s = runs["live"].summary()
    assert s["completed"] == 3 and s["straggler_recoveries"] >= 1
    for key in ("ttft_p50_ms", "token_p50_ms", "token_p99_ms"):
        assert s[key] is not None and s[key] >= 0.0


def test_engine_refuses_a_survivor_set_that_loses_rank():
    cfg = tcfg.get("qwen3-moe-30b-a3b").reduced()
    surv = np.zeros(6, dtype=bool)
    surv[:3] = True
    with pytest.raises(DecodingError):
        ServingEngine(cfg, device="cpu", moe_survivors=surv)
    with pytest.raises(ValueError, match="needs a MoE config"):
        ServingEngine(tcfg.get("internlm2-1.8b").reduced(), device="cpu")
