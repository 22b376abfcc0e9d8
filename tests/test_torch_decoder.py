"""The port's hybrid peeling/rooting decoder against the JAX package's.

* ``peel_schedule`` over every registered scheme's generator matrix, atomic
  and chunk-expanded, over all rows and over random row subsets, with every
  ``root_pick``: the same schedule (every op, every rooting row and
  coefficient) and the same ``DecodeStats``, bit for bit -- or the same
  ``DecodingError``;
* ``hybrid_decode`` and ``gaussian_decode`` on float64 blocks, as dense
  torch tensors and as sparse CSR: within 1e-10 of the reference's numpy /
  scipy result (the same f64 operations in the same order; 1e-10 leaves
  room only for scipy's and torch's CSR adds), and a CSR block stays CSR;
* ``IncrementalRankTracker``: the same decision on every arrival, over
  random arrival orders.
"""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from repro.coded import registry as jax_registry  # noqa: E402
from repro.core import decoder as jd  # noqa: E402
from repro.core.encoder import chunk_expand as jax_chunk_expand  # noqa: E402

from repro_torch.core import blocks as pb  # noqa: E402
from repro_torch.core import decoder as pd  # noqa: E402

CPU = torch.device("cpu")
SHAPES = [(2, 2, 8), (3, 3, 20), (2, 3, 14)]
TOL = 1e-10


def _M(name: str, m: int, n: int, N: int, q: int) -> sp.csr_matrix:
    scheme = jax_registry.get_scheme(name)
    inst = scheme.instance(m, n, None if scheme.fixed_workers else N, seed=1)
    return jax_chunk_expand(inst.M, q)


def _schedule_or_error(mod, M, root_pick, seed):
    try:
        return mod.peel_schedule(M, rng=np.random.default_rng(seed),
                                 root_pick=root_pick)
    except mod.DecodingError as e:
        return str(e)


def _assert_same_schedule(got, want):
    if isinstance(want, str):
        assert got == want
        return
    (sched_p, stats_p), (sched_j, stats_j) = got, want
    assert stats_p.as_dict() == stats_j.as_dict()
    assert len(sched_p) == len(sched_j)
    for op_p, op_j in zip(sched_p, sched_j):
        assert op_p[0] == op_j[0] and len(op_p) == len(op_j)
        for a, b in zip(op_p[1:], op_j[1:]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), (op_p, op_j)


@pytest.mark.parametrize("root_pick", ["random", "max_rows", "fail"])
@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("m,n,N", SHAPES)
@pytest.mark.parametrize("name", jax_registry.scheme_names())
def test_peel_schedule_matches_reference_bitwise(name, m, n, N, q, root_pick):
    M = _M(name, m, n, N, q)
    _assert_same_schedule(_schedule_or_error(pd, M, root_pick, 7),
                          _schedule_or_error(jd, M, root_pick, 7))
    # random row subsets near the recovery threshold: rooting steps, and
    # rank-deficient subsets that must fail the same way
    rng = np.random.default_rng(m * 100 + N + q)
    for extra in (0, 2, 5):
        k = min(M.shape[0], m * n + extra)
        rows = np.sort(rng.choice(M.shape[0], size=k, replace=False))
        _assert_same_schedule(_schedule_or_error(pd, M[rows], root_pick, extra),
                              _schedule_or_error(jd, M[rows], root_pick, extra))


def _csr(x: np.ndarray) -> sp.csr_matrix:
    return sp.csr_matrix(np.where(np.abs(x) > 0.8, x, 0.0))


def _to_numpy(b) -> np.ndarray:
    if isinstance(b, torch.Tensor):
        return (b.to_dense() if pb.is_csr(b) else b).numpy()
    return b.toarray() if sp.issparse(b) else np.asarray(b)


def _case(name: str, m: int, n: int, N: int, sparse: bool, seed: int = 0):
    """A decodable row subset of the scheme's M and its exact results
    (R = M_sub @ blocks), as the reference's and the port's inputs."""
    rng = np.random.default_rng(seed)
    dense = [rng.standard_normal((5, 6)) for _ in range(m * n)]
    blocks = [_csr(b) for b in dense] if sparse else dense
    M = _M(name, m, n, N, 1)
    for _ in range(50):
        k = min(M.shape[0], m * n + 3)
        rows = np.sort(rng.choice(M.shape[0], size=k, replace=False))
        if np.linalg.matrix_rank(M[rows].toarray()) == m * n:
            break
    sub = M[rows]
    results = []
    for r in range(sub.shape[0]):
        lo, hi = sub.indptr[r], sub.indptr[r + 1]
        acc = None
        for c, w in zip(sub.indices[lo:hi], sub.data[lo:hi]):
            term = blocks[c] * w
            acc = term if acc is None else acc + term
        results.append(acc)
    return sub, blocks, results


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("m,n,N", SHAPES)
@pytest.mark.parametrize("name", ["sparse_code", "lt_code", "sparse_mds",
                                  "polynomial", "product"])
def test_hybrid_and_gaussian_decode_match_reference(name, m, n, N, sparse):
    sub, blocks, results = _case(name, m, n, N, sparse)
    results_t = pb.blocks_to_device(results, CPU)
    want_h, stats_j = jd.hybrid_decode(sub, results, rng=np.random.default_rng(3))
    got_h, stats_p = pd.hybrid_decode(sub, results_t, rng=np.random.default_rng(3))
    assert stats_p.as_dict() == stats_j.as_dict()
    want_g = jd.gaussian_decode(sub, results)
    got_g = pd.gaussian_decode(sub, results_t)
    for got, want in ((got_h, want_h), (got_g, want_g)):
        assert len(got) == len(want) == m * n
        for g, w, truth in zip(got, want, blocks):
            assert g.dtype == torch.float64
            assert g.layout == (torch.sparse_csr if sparse else torch.strided)
            np.testing.assert_allclose(_to_numpy(g), _to_numpy(w), rtol=0, atol=TOL)
            np.testing.assert_allclose(_to_numpy(g), _to_numpy(truth), rtol=0,
                                       atol=1e-8)


def test_apply_schedule_replays_dense_bit_for_bit():
    """Dense f64 blocks: the same ops in the same order -- the port's
    a + b * (-w) axpy is the reference's a - b * w, bit for bit."""
    sub, _, results = _case("sparse_code", 3, 3, 20, sparse=False, seed=4)
    sched, _ = jd.peel_schedule(sub, rng=np.random.default_rng(0))
    want = jd.apply_schedule(sched, results)
    got = pd.apply_schedule(sched, pb.blocks_to_device(results, CPU))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("d,K", [(4, 10), (9, 20), (12, 12)])
def test_rank_tracker_decisions_match_reference(d, K, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-3, 4, size=(K, d)).astype(np.float64)
    rows[rng.random(K) < 0.3] = 0.0                 # empty rows
    rows[::4] = rows[::4] * 0 + rows[0]             # repeated rows
    tj, tp = jd.IncrementalRankTracker(d), pd.IncrementalRankTracker(d)
    for r in rng.permutation(K):
        row = sp.csr_matrix(rows[r]) if r % 2 else rows[r]
        assert tp.add(row) == tj.add(row)
        assert (tp.rank, tp.rows_seen, tp.is_full) == (tj.rank, tj.rows_seen, tj.is_full)
    with pytest.raises(ValueError, match="tracker dim"):
        pd.IncrementalRankTracker(d).add(np.ones(d + 1))


def test_decoding_errors_raised_in_the_same_cases():
    M = sp.csr_matrix(np.array([[1.0, 2.0, 0.0], [2.0, 4.0, 0.0], [0.0, 0.0, 1.0]]))
    results = [np.ones((2, 2)) for _ in range(3)]
    results_t = pb.blocks_to_device(results, CPU)
    for mod, res in ((jd, results), (pd, results_t)):
        with pytest.raises(mod.DecodingError, match="rank 2 < 3"):
            mod.peel_schedule(M)
        with pytest.raises(mod.DecodingError, match="not full column rank"):
            mod.gaussian_decode(M, res)
        with pytest.raises(mod.DecodingError, match="rank 2 < 3"):
            mod.hybrid_decode(M, res)
    # peeling stalls on a full-rank matrix without a ripple
    M2 = sp.csr_matrix(np.array([[1.0, 1.0], [1.0, -1.0]]))
    for mod in (jd, pd):
        with pytest.raises(mod.DecodingError, match="rooting disabled"):
            mod.peel_schedule(M2, root_pick="fail")
    assert issubclass(pd.DecodingError, ValueError)
