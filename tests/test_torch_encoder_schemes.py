"""The port's encoder, codes, degree tools, matching and LP design against
the JAX package's.

Host artifacts match bit for bit: ``make_tasks`` and ``CodedTask.chunks``,
``chunk_expand`` (its CSR arrays), ``ChunkedCode.chunk_work``,
``can_decode`` over random worker and chunk subsets, the registry's
``chunked``/``device_capable``, ``degree``'s generator polynomials, the
perfect-matching probabilities and the LP designs.  ``encode_blocks`` and
``compute_block_products`` on float64 torch blocks, dense and sparse CSR,
agree within 1e-12 of the reference's numpy / scipy products (torch's and
scipy's sums of products differ at most in their order), and ``split_blocks``
splits a CSR tensor into the blocks scipy slices out.
"""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from repro.coded import registry as jax_registry  # noqa: E402
from repro.core import degree as jdeg  # noqa: E402
from repro.core import encoder as je  # noqa: E402
from repro.core import lp_design as jlp  # noqa: E402
from repro.core import matching as jmatch  # noqa: E402

from repro_torch.coded import registry as port_registry  # noqa: E402
from repro_torch.core import blocks as pb  # noqa: E402
from repro_torch.core import degree as pdeg  # noqa: E402
from repro_torch.core import encoder as pe  # noqa: E402
from repro_torch.core import lp_design as plp  # noqa: E402
from repro_torch.core import matching as pmatch  # noqa: E402

CPU = torch.device("cpu")
NAMES = jax_registry.scheme_names()


def _instances(name, m=3, n=2, N=14, seed=2):
    js, ps = jax_registry.get_scheme(name), port_registry.get_scheme(name)
    N = None if js.fixed_workers else N
    return js.instance(m, n, N, seed=seed), ps.instance(m, n, N, seed=seed)


def _same_csr(a: sp.csr_matrix, b: sp.csr_matrix):
    assert a.shape == b.shape
    for f in ("indptr", "indices", "data"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _same_task(a, b):
    assert (a.worker, a.chunk, a.degree) == (b.worker, b.chunk, b.degree)
    assert np.array_equal(a.cols, b.cols) and a.cols.dtype == b.cols.dtype
    assert np.array_equal(a.weights, b.weights) and a.weights.dtype == b.weights.dtype


@pytest.mark.parametrize("q", [1, 2, 3, 5])
@pytest.mark.parametrize("name", NAMES)
def test_tasks_chunks_and_chunk_work_match_bitwise(name, q):
    ji, pi = _instances(name)
    _same_csr(ji.M, pi.M)
    jt, pt = je.make_tasks(ji.M), pe.make_tasks(pi.M)
    assert len(jt) == len(pt)
    for a, b in zip(jt, pt):
        _same_task(a, b)
        assert a.pairs(2) == b.pairs(2)
        for ca, cb in zip(a.chunks(q), b.chunks(q)):
            _same_task(ca, cb)
    _same_csr(je.chunk_expand(ji.M, q), pe.chunk_expand(pi.M, q))
    jc, pc = ji.chunked(q), pi.chunked(q)
    _same_csr(jc.M, pc.M)
    assert jc.name == pc.name and jc.num_workers == pc.num_workers
    assert np.array_equal(jc.chunk_work(), pc.chunk_work())
    assert [jc.expanded_rows(w, c) for w in range(jc.num_workers) for c in range(q)] \
        == [pc.expanded_rows(w, c) for w in range(pc.num_workers) for c in range(q)]


@pytest.mark.parametrize("name", NAMES)
def test_can_decode_over_random_subsets_matches(name):
    ji, pi = _instances(name)
    rng = np.random.default_rng(5)
    N = ji.num_workers
    for _ in range(12):
        workers = rng.choice(N, size=rng.integers(1, N + 1), replace=False).tolist()
        assert pi.rows_of(workers) == ji.rows_of(workers)
        assert pi.can_decode(workers) == ji.can_decode(workers)
    jc, pc = ji.chunked(3), pi.chunked(3)
    for _ in range(12):
        progress = rng.integers(0, 4, size=N)
        pairs = [(w, c) for c in range(3) for w in rng.permutation(N) if c < progress[w]]
        assert pc.rows_of(pairs) == jc.rows_of(pairs)
        assert pc.can_decode(pairs) == jc.can_decode(pairs)


@pytest.mark.parametrize("name", NAMES)
def test_registry_chunked_and_device_capable_match(name):
    js, ps = jax_registry.get_scheme(name), port_registry.get_scheme(name)
    N = None if js.fixed_workers else 10
    kw = {"num_workers": 4} if js.fixed_workers else {}
    assert ps.device_capable(**kw) == js.device_capable(**kw)
    jc = js.chunked(2, 2, N, num_chunks=3, seed=4)
    pc = ps.chunked(2, 2, N, num_chunks=3, seed=4)
    _same_csr(jc.M, pc.M)
    assert (jc.name, jc.num_chunks) == (pc.name, pc.num_chunks)


def test_degree_tools_match_bitwise():
    xs = np.linspace(0.0, 1.0, 33)
    for d in (4, 9, 16, 25, 40):
        for dist in ("wave_soliton", "robust_soliton", "ideal_soliton", "optimized"):
            p = jdeg.get_distribution(dist, d)
            assert np.array_equal(pdeg.get_distribution(dist, d), p)
            assert pdeg.average_degree(p) == jdeg.average_degree(p)
            assert np.array_equal(pdeg.degree_generator_poly(p, xs),
                                  jdeg.degree_generator_poly(p, xs))
            assert np.array_equal(pdeg.degree_generator_dpoly(p, xs),
                                  jdeg.degree_generator_dpoly(p, xs))


def test_matching_matches_bitwise():
    for d in (4, 9, 16):
        p = jdeg.wave_soliton(d)
        assert np.array_equal(pmatch.degree_evolution(p), jmatch.degree_evolution(p))
        assert pmatch.perfect_matching_prob(p) == jmatch.perfect_matching_prob(p)
        assert (pmatch.empirical_matching_prob(p, 30, np.random.default_rng(1))
                == jmatch.empirical_matching_prob(p, 30, np.random.default_rng(1)))


@pytest.mark.parametrize("method", ["lp", "hybrid", "slsqp"])
def test_lp_design_matches_bitwise(method):
    for d in (4, 9):
        kw = dict(method=method, mc_trials=20, seed=3)
        assert np.array_equal(plp.optimize_degree_distribution(d, **kw),
                              jlp.optimize_degree_distribution(d, **kw))


def _operands(sparse: bool, m=3, n=2, s=30, r=12, t=10, seed=0):
    rng = np.random.default_rng(seed)
    A, B = rng.standard_normal((s, r)), rng.standard_normal((s, t))
    if sparse:
        A, B = (sp.csr_matrix(np.where(rng.random(X.shape) < 0.3, X, 0.0))
                for X in (A, B))
    return A, B, je.split_blocks(A, m), je.split_blocks(B, n)


def _dense(b) -> np.ndarray:
    if isinstance(b, torch.Tensor):
        return (b.to_dense() if pb.is_csr(b) else b).numpy()
    return b.toarray() if sp.issparse(b) else np.asarray(b)


@pytest.mark.parametrize("held", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
def test_encode_blocks_and_block_products_match(sparse, held):
    m, n = 3, 2
    _, _, Ab, Bb = _operands(sparse, m, n)
    At = pb.hold_a_blocks(Ab, CPU) if held else pb.blocks_to_device(Ab, CPU)
    Bt = pb.blocks_to_device(Bb, CPU)
    layout = torch.sparse_csr if sparse else torch.strided
    code = jax_registry.get_scheme("sparse_code").instance(m, n, 12, seed=1)
    if sparse and not held:
        # a bare CSR block of A would be transposed again for every product
        with pytest.raises(ValueError, match="hold_a_blocks"):
            pe.encode_blocks(pe.make_tasks(code.M)[0], At, Bt, n)
        with pytest.raises(ValueError, match="hold_a_blocks"):
            pe.compute_block_products(At, Bt)
        return
    for tj in je.make_tasks(code.M):
        for chunk in tj.chunks(2):
            want = je.encode_blocks(chunk, Ab, Bb, n)
            got = pe.encode_blocks(chunk, At, Bt, n)
            if want is None:
                assert got is None
                continue
            assert got.layout == layout and got.dtype == torch.float64
            np.testing.assert_allclose(_dense(got), _dense(want), rtol=0, atol=1e-12)
    want = je.compute_block_products(Ab, Bb)
    got = pe.compute_block_products(At, Bt)
    for gi, wi in zip(got, want):
        for g, w in zip(gi, wi):
            assert g.layout == layout
            np.testing.assert_allclose(_dense(g), _dense(w), rtol=0, atol=1e-12)


def test_split_blocks_of_a_csr_tensor_matches_scipy():
    A, B, Ab, _ = _operands(sparse=True)
    parts = pe.split_blocks(pb.to_device(A, CPU), 3)
    assert [p.layout for p in parts] == [torch.sparse_csr] * 3
    for got, want in zip(parts, Ab):
        assert np.array_equal(_dense(got), want.toarray())
    dense = pe.split_blocks(torch.from_numpy(B.toarray()), 2)
    assert all(np.array_equal(_dense(g), w.toarray()) for g, w in
               zip(dense, je.split_blocks(B, 2)))
    with pytest.raises(ValueError, match="not divisible"):
        pe.split_blocks(pb.to_device(A, CPU), 5)
    with pytest.raises(ValueError, match="columns only"):
        pe.split_blocks(pb.to_device(A, CPU), 3, axis=0)
