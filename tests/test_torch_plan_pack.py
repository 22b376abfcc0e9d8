"""Host plans and tile packs of the port against the JAX package, bit for bit.

The same scheme, m, n, N and seed give the same plan in both packages
(every field ``np.array_equal``), the same survivor and chunk rebinds (the
same decode matrices, and ``DecodingError`` on the same masks), the same
BlockELL, and the same worker tile packs in f32, bf16 (compared after the
exact upcast to f32) and int8 with its per-tile scales.  The plan and pack
also cross over through ``plan_from_numpy`` / ``pack_from_numpy`` unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.coded import registry as jax_registry  # noqa: E402
from repro.core import coded_matmul as jax_cm  # noqa: E402
from repro.core.decoder import DecodingError as JaxDecodingError  # noqa: E402
from repro.sparse import blocksparse as jax_bs  # noqa: E402

from repro_torch.coded import registry as port_registry  # noqa: E402
from repro_torch.coded.convert import pack_from_numpy, plan_from_numpy  # noqa: E402
from repro_torch.core import coded_matmul as port_cm  # noqa: E402
from repro_torch.core.decoder import DecodingError as PortDecodingError  # noqa: E402
from repro_torch.sparse import blocksparse as port_bs  # noqa: E402

#: every device-capable scheme at (m, n, N) = (2, 2, 8), and uncoded at N = mn
SCHEMES = [("sparse_code", 8), ("lt_code", 8), ("sparse_mds", 8),
           ("polynomial", 8), ("product", 8), ("uncoded", 4)]
PLAN_FIELDS = ("cols", "weights", "decode", "max_degree")


def _plans(name: str, N: int, seed: int = 0):
    jp = jax_registry.get_scheme(name).plan(2, 2, N, seed=seed)
    pp = port_registry.get_scheme(name).plan(2, 2, N, seed=seed)
    return jp, pp


def plan_fields(p) -> dict:
    return {**{f: getattr(p, f) for f in PLAN_FIELDS},
            "m": p.m, "n": p.n, "num_workers": p.num_workers}


def assert_plans_equal(jp, pp):
    for f in PLAN_FIELDS:
        a, b = np.asarray(getattr(jp, f)), np.asarray(getattr(pp, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (jp.m, jp.n, jp.num_workers) == (pp.m, pp.n, pp.num_workers)
    assert np.array_equal(jp.coefficient_matrix(), pp.coefficient_matrix())


@pytest.mark.parametrize("name,N", SCHEMES)
def test_registry_plans_match_bitwise(name, N):
    jp, pp = _plans(name, N)
    assert_plans_equal(jp, pp)
    assert (jp.spec.scheme, jp.spec.seed) == (pp.spec.scheme, pp.spec.seed)
    # and the plan crosses over from plain arrays unchanged
    assert_plans_equal(jp, plan_from_numpy(plan_fields(jp)))


@pytest.mark.parametrize("name,N", SCHEMES)
@pytest.mark.parametrize("dead", [(3,), (1, 6)])
def test_survivor_rebinds_match_bitwise(name, N, dead):
    jp, pp = _plans(name, N)
    surv = np.ones(N, dtype=bool)
    surv[[d % N for d in dead]] = False
    try:
        jr = jp.with_survivors(surv)
    except JaxDecodingError:
        with pytest.raises(PortDecodingError):
            pp.with_survivors(surv)
        return
    assert_plans_equal(jr, pp.with_survivors(surv))


def test_undecodable_masks_raise_in_both():
    # uncoded has no redundancy: any dead worker loses rank
    jp, pp = _plans("uncoded", 4)
    surv = np.array([True, False, True, True])
    with pytest.raises(JaxDecodingError):
        jp.with_survivors(surv)
    with pytest.raises(PortDecodingError):
        pp.with_survivors(surv)
    # three survivors of eight cannot span mn = 4 blocks
    jp, pp = _plans("sparse_code", 8)
    surv = np.zeros(8, dtype=bool)
    surv[:3] = True
    with pytest.raises(JaxDecodingError):
        jp.with_survivors(surv)
    with pytest.raises(PortDecodingError):
        pp.with_survivors(surv)


@pytest.mark.parametrize("name", ["sparse_code", "sparse_mds"])
def test_chunk_mask_rebinds_match_bitwise(name):
    jp, pp = _plans(name, 8)
    mask = np.ones((8, 2), dtype=bool)
    mask[1, 1] = False           # worker 1 finished its first chunk only
    mask[4] = False              # worker 4 finished nothing
    assert np.array_equal(jax_cm.chunk_mask_progress(mask, 8),
                          port_cm.chunk_mask_progress(mask, 8))
    assert_plans_equal(jp.with_survivors(mask), pp.with_survivors(mask))
    bad = mask.copy()
    bad[2] = [False, True]       # not prefix-form
    with pytest.raises(ValueError, match="prefix-form"):
        pp.with_survivors(bad)


def test_make_plan_matches_bitwise():
    jp = jax_cm.make_plan(2, 3, 8, seed=5)
    pp = port_cm.make_plan(2, 3, 8, seed=5)
    assert_plans_equal(jp, pp)


def _sparse_A(seed: int, s: int = 64, r: int = 16, bs: int = 8,
              density: float = 0.4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    mask = rng.random((s // bs, r // bs)) < density
    return (rng.standard_normal((s, r)) * np.kron(mask, np.ones((bs, bs)))
            ).astype(np.float32)


def test_block_ell_matches_bitwise():
    A = _sparse_A(1, r=32)
    je, pe = jax_bs.dense_to_block_ell(A, 8), port_bs.dense_to_block_ell(A, 8)
    for f in ("vals", "idx", "nnzb"):
        assert np.array_equal(getattr(je, f), getattr(pe, f)), f
    assert (je.shape, je.block_size, je.density()) == (
        pe.shape, pe.block_size, pe.density())
    assert np.array_equal(port_bs.block_ell_to_dense(pe), A)


def pack_fields(pack) -> dict:
    """A pack's fields as numpy arrays; bf16 tiles as their exact f32
    upcast (numpy has no bfloat16)."""
    vals = pack.vals
    if isinstance(vals, torch.Tensor):
        vals = vals.float() if vals.dtype == torch.bfloat16 else vals
        vals = vals.numpy()
    elif pack.compute_dtype == "bfloat16":
        vals = np.asarray(vals).astype(np.float32)
    return {"vals": vals, "src": pack.src, "wslot": pack.wslot,
            "block_size": pack.block_size, "live_tiles": pack.live_tiles,
            "slot_of": pack.slot_of, "compute_dtype": pack.compute_dtype,
            "tile_scale": pack.tile_scale}


def assert_packs_equal(jpack, ppack):
    want, got = pack_fields(jpack), pack_fields(ppack)
    for f, a in want.items():
        b = got[f]
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name,N", [("sparse_code", 8), ("polynomial", 8)])
def test_worker_tile_packs_match_bitwise(name, N, compute_dtype):
    jp, pp = _plans(name, N)
    A = _sparse_A(2)
    jpack = jax_cm.pack_worker_tiles(jax_bs.dense_to_block_ell(A, 8), jp,
                                     compute_dtype=compute_dtype)
    ppack = port_cm.pack_worker_tiles(port_bs.dense_to_block_ell(A, 8), pp,
                                      compute_dtype=compute_dtype)
    assert_packs_equal(jpack, ppack)
    assert (ppack.tile_scale is not None) == (compute_dtype == "int8")
    assert_packs_equal(jpack, pack_from_numpy(pack_fields(jpack)))


def test_pack_from_numpy_refuses_values_that_are_not_bfloat16():
    jp, _ = _plans("sparse_code", 8)
    jpack = jax_cm.pack_worker_tiles(
        jax_bs.dense_to_block_ell(_sparse_A(3), 8), jp)
    fields = {**pack_fields(jpack), "compute_dtype": "bfloat16"}
    with pytest.raises(ValueError, match="not bfloat16"):
        pack_from_numpy(fields)


@pytest.mark.parametrize("kwargs", [
    {"scheme": "nope"},
    {"backend": "nope"},
    {"block_size": 0},
    {"auto_density_threshold": 1.5},
    {"compute_dtype": "float16", "backend": "block_sparse"},
    {"compute_dtype": "bfloat16", "backend": "dense_scan"},
    {"compute_dtype": "int8", "backend": "block_sparse", "scheme": "product"},
    {"out_dtype": "float64"},
    {"out_dtype": np.complex128},
])
def test_config_refuses_what_the_reference_refuses(kwargs):
    from repro.coded import CodedMatmulConfig as JaxConfig

    from repro_torch.coded import CodedMatmulConfig as PortConfig

    with pytest.raises(ValueError):
        JaxConfig(**kwargs)
    with pytest.raises(ValueError):
        PortConfig(**kwargs)


def test_config_defaults_and_dtype_spellings_match():
    from repro.coded import CodedMatmulConfig as JaxConfig

    from repro_torch.coded import CodedMatmulConfig as PortConfig

    assert (dataclasses.asdict(JaxConfig())
            == dataclasses.asdict(PortConfig()))
    for spelling in (np.float32, "f4", "float16"):
        assert JaxConfig(out_dtype=spelling).out_dtype == \
            PortConfig(out_dtype=spelling).out_dtype
    assert PortConfig(out_dtype=torch.bfloat16).torch_dtype == torch.bfloat16


def test_packs_cross_to_the_device_once():
    from repro_torch.coded import CodedMatmulConfig, plan
    from repro_torch.runtime import pack_cache

    pack_cache.clear()
    A = _sparse_A(4)
    rng = np.random.default_rng(4)
    B = rng.standard_normal((64, 24)).astype(np.float32)
    ell = port_bs.dense_to_block_ell(A, 8)
    op = plan(CodedMatmulConfig(backend="block_sparse"), 2, 2, 8).bind("cpu")
    surv = np.ones(8, dtype=bool)
    surv[3] = False
    C1 = op(A, B, a_sparse=ell)
    C2 = op.with_survivors(surv)(A, B, a_sparse=ell)  # same pack, new decode
    op(A, B)                                            # a pack for this call only
    stats = pack_cache.cache_stats()
    assert (stats["entries"], stats["device_entries"]) == (1, 1)
    assert (stats["misses"], stats["hits"]) == (2, 2)
    for C in (C1, C2):
        np.testing.assert_allclose(C.numpy(), A.T @ B, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(A.T @ B).max()))
    pack_cache.clear()
