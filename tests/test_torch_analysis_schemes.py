"""The port's scheme checks against the JAX package's, on the CPU.

* ``validate_scheme`` for every registered scheme over one small config,
  and for ``sparse_code`` over the default sweep: the reference's findings,
  ``(rule, severity, message)`` for ``(rule, severity, message)`` (the
  anchor names each package's own file, so it is left out);
* the planted-scheme tests of the reference (a false exactness claim,
  empty generator rows, findings anchored at the builder) against the
  port's registry, each also held to the reference's findings;
* ``check_pack_consistency`` on the port's packs, whose ``vals`` is a CPU
  torch tensor -- f32, bf16 or int8 -- and ``validate_pack`` on a caller's
  operand, clean and with each contract broken once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from repro.analysis import schemes as ja  # noqa: E402
from repro.coded import registry as jreg  # noqa: E402
from repro.core import schemes as js  # noqa: E402

from repro_torch.analysis import ERROR, Finding, Report  # noqa: E402
from repro_torch.analysis import schemes as pa  # noqa: E402
from repro_torch.coded import registry as preg  # noqa: E402
from repro_torch.core import coded_matmul as pcm  # noqa: E402
from repro_torch.core import schemes as ps  # noqa: E402
from repro_torch.sparse import dense_to_block_ell  # noqa: E402


def _key(findings):
    return [(f.rule, f.severity, f.message) for f in findings]


def test_registries_hold_the_same_schemes():
    assert preg.scheme_names() == jreg.scheme_names()


@pytest.mark.parametrize("name", preg.scheme_names())
def test_findings_match_reference_on_a_small_config(name):
    kw = dict(configs=((2, 2, 8),), chunks=(1, 2), trials=8)
    got = pa.validate_scheme(name, **kw)
    assert _key(got) == _key(ja.validate_scheme(name, **kw))
    assert all(f.layer == "schemes" and f.line > 0 for f in got)


def test_sparse_code_default_sweep_matches_reference():
    got = pa.validate_scheme("sparse_code")
    assert _key(got) == _key(ja.validate_scheme("sparse_code")) == []


def test_run_scheme_checks_finds_no_error_on_the_registry():
    findings, count = pa.run_scheme_checks()
    assert count == len(preg.scheme_names())
    report = Report(findings=findings, checked={"schemes": count})
    assert report.count(ERROR) == 0 and report.exit_code() == 0
    assert "repro_torch.analysis: 0 error(s)" in report.render()


@pytest.fixture
def planted():
    """Register a builder under one name in both registries; unregister
    after the test."""
    names = []

    def register(name, port_builder, ref_builder, **kw):
        preg.register_scheme(name, port_builder, **kw.get("port", {}))
        jreg.register_scheme(name, ref_builder, **kw.get("ref", {}))
        names.append(name)

    yield register
    for name in names:
        preg._REGISTRY.pop(name, None)
        jreg._REGISTRY.pop(name, None)


def test_scheme_validator_flags_false_exactness_claim(planted):
    name = "bad_exact_claim"
    claim = dict(exact=True, mean_overhead=0.0, max_overhead=0.0)
    planted(name,
            lambda m, n, N, *, seed=0: ps.sparse_code(m, n, N, seed=seed),
            lambda m, n, N, *, seed=0: js.sparse_code(m, n, N, seed=seed),
            port={"invariants": ps.SchemeInvariants(**claim)},
            ref={"invariants": js.SchemeInvariants(**claim)})
    got = pa.validate_scheme(name)
    assert "recovery-threshold" in {f.rule for f in got}
    assert _key(got) == _key(ja.validate_scheme(name))


def test_scheme_validator_flags_empty_generator_rows(planted):
    def degenerate(mod):
        def build(m, n, N, *, seed=0):
            # N workers but only mn useful rows: the rest are EMPTY
            return mod.CodeInstance(name="degenerate",
                                    M=sp.csr_matrix(np.eye(N, m * n)),
                                    worker_rows=[[k] for k in range(N)],
                                    cost_factor=np.ones(N), decode_kind="hybrid")
        return build

    planted("bad_empty_rows", degenerate(ps), degenerate(js))
    got = pa.validate_scheme("bad_empty_rows")
    assert "degree-sanity" in {f.rule for f in got}
    assert _key(got) == _key(ja.validate_scheme("bad_empty_rows"))


def test_scheme_validator_findings_anchor_at_builder(planted):
    claim = dict(exact=True, mean_overhead=0.0, max_overhead=0.0)
    planted("bad_anchored",
            lambda m, n, N, *, seed=0: preg.get_scheme(
                "sparse_code").instance(m, n, N, seed=seed),
            lambda m, n, N, *, seed=0: jreg.get_scheme(
                "sparse_code").instance(m, n, N, seed=seed),
            port={"invariants": ps.SchemeInvariants(**claim)},
            ref={"invariants": js.SchemeInvariants(**claim)})
    findings = pa.validate_scheme("bad_anchored")
    assert findings
    # the anchor is THIS test file (where the builder lambda lives)
    assert all(f.path.endswith("test_torch_analysis_schemes.py") for f in findings)
    assert all(f.line > 0 for f in findings)
    assert all(isinstance(f, Finding) for f in findings)


# ------------------------------- tile packs ----------------------------------

def _operand(seed=0, s=64, r=32, bs=8, density=0.4):
    rng = np.random.default_rng(seed)
    mask = rng.random((s // bs, r // bs)) < density
    A = (rng.standard_normal((s // bs, bs, r // bs, bs), dtype=np.float32)
         * mask[:, None, :, None]).reshape(s, r)
    return A, dense_to_block_ell(A, bs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_check_pack_consistency_takes_the_ports_packs(dtype, monkeypatch):
    """Every registered device scheme's pack, its tile values a CPU torch
    tensor of each compute dtype, passes the checks."""
    real = pcm.pack_worker_tiles
    monkeypatch.setattr(pcm, "pack_worker_tiles",
                        lambda ell, plan: real(ell, plan, compute_dtype=dtype))
    for name in ("sparse_code", "uncoded", "lt_code", "polynomial"):
        scheme = preg.get_scheme(name)
        plan = scheme.plan(2, 2, None if scheme.fixed_workers else 8, seed=0)
        ctx = pa._Ctx(name=name, scheme=scheme, inv=scheme.invariants or pa.PERMISSIVE,
                      findings=[])
        pa.check_pack_consistency(ctx, plan, 2, 2, np.random.default_rng(1))
        assert ctx.findings == []
        pack = pcm.pack_worker_tiles(*_operand()[1:], plan)
        assert isinstance(pack.vals, torch.Tensor)
        assert pack.vals.dtype == getattr(torch, dtype)


def test_validate_pack_is_clean_and_sees_each_broken_contract():
    scheme = preg.get_scheme("sparse_code")
    plan = scheme.plan(2, 2, 8, seed=0)
    A, ell = _operand()
    pack = pcm.pack_worker_tiles(ell, plan)
    assert pa.validate_pack(plan, A, ell, pack) == []

    def rules(A_, ell_, pack_):
        return {f.rule + ": " + f.message.split(") ", 1)[1]
                for f in pa.validate_pack(plan, A_, ell_, pack_)}

    pad = np.argwhere(pack.wslot == 0.0)[0]
    vals = pack.vals.clone()
    vals[tuple(pad)] = 1.0
    src = pack.src.copy()
    src[..., 0] = ell.shape[0] // ell.block_size
    slot_of = pack.slot_of.copy()
    live = np.argwhere(pack.wslot != 0.0)[0]
    slot_of[tuple(live)] = (slot_of[tuple(live)] + 1) % plan.cols.shape[1]
    A_other = A.copy()
    A_other[0, 0] += 1.0
    broken = {
        "pads carry values": (A, ell, dataclasses.replace(pack, vals=vals)),
        "row blocks out of range": (A, ell, dataclasses.replace(pack, src=src)),
        "slot_of wrong": (A, ell, dataclasses.replace(pack, slot_of=slot_of)),
        "no slot_of": (A, ell, dataclasses.replace(pack, slot_of=None)),
        "live_tiles wrong": (A, ell, dataclasses.replace(pack, live_tiles=pack.live_tiles + 1)),
        "ell of another operand": (A_other, ell, pack),
    }
    seen = {case: rules(*args) for case, args in broken.items()}
    assert all(len(found) >= 1 for found in seen.values()), seen
    assert any("padding slots" in r for r in seen["pads carry values"])
    assert any("row-block addresses" in r for r in seen["row blocks out of range"])
    assert any("re-gathering weights" in r for r in seen["slot_of wrong"])
    assert any("no slot_of map" in r for r in seen["no slot_of"])
    assert any("live_tiles" in r for r in seen["live_tiles wrong"])
    assert any("round-trip" in r for r in seen["ell of another operand"])
