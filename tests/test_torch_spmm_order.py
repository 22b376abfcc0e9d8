"""The SpMM kernel's slot order, and its summation order, on the CPU.

``csrc/spmm_block.cu`` streams B through shared memory once per group of
column blocks, so each column block walks its slots sorted by the B tile
they read: ``kernels.spmm_block.slot_order``, made by the wrapper at each
launch.  These tests hold:

* the order: a stable sort of each row by key = column group * (s/bs) +
  row-block, the same for any s/bs past the largest row-block, unchanged by
  survivor and chunk rebinds (which change only the weights), walking
  every worker's pack of every tile dtype in B's address order;
* the copy path the wrapper asks the kernel for (``copy_path``): the copy
  engine only where B's rows and start lie on 16 bytes;
* the kernel's arithmetic: a plain emulation of its summation order (the
  slots of each column block in key order, weight-0 slots skipped, then the
  bs rows of each tile, one IEEE f32 fused multiply-add each; w folded into
  the tile, or applied to each slot's dot as the first design did) against
  the JAX package's interpreted Pallas kernels and its jnp oracle, at
  ``tests/test_torch_kernels.py``'s shapes, within its tolerance (1e-5 of
  the largest output: the forms differ only in the order of f32 sums);
* the build: a library found built keeps ptxas's report of its kernels
  (``chip_smoke.py`` prints each instance's registers and spills).

The kernel itself runs only on the card (``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.spmm_block import (  # noqa: E402
    _spmm_block_fused_decode_pallas,
    _spmm_block_fused_pallas,
)
from repro.kernels.spmm_block import spmm_block as jax_spmm_block  # noqa: E402
from repro.sparse import dense_to_block_ell as jax_dense_to_block_ell  # noqa: E402

from repro_torch.coded import CodedMatmulConfig, plan  # noqa: E402
from repro_torch.core.coded_matmul import _block_sparse_operands  # noqa: E402
from repro_torch.core.decoder import DecodingError  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.spmm_block import copy_path, slot_order  # noqa: E402
from repro_torch.runtime import pack_cache  # noqa: E402
from repro_torch.sparse import dense_to_block_ell  # noqa: E402

RTOL = 1e-5
CPU = torch.device("cpu")


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fl32(a * b + c) for f32 operands: the product is exact in f64."""
    return (a.double() * b.double() + c.double()).float()


def emulate_slot_loop(vals, src, wslot, B, bt: int, order, *, fold: bool = True,
                      plain: bool = False) -> torch.Tensor:
    """The kernel's sum for every output, in its order: (CB * bs, bt) f32.

    For each column block, the slots in ``order`` (weight-0 slots skipped,
    unless ``plain``), and in each slot the bs rows i of the tile:
    acc = fma(w * a[i], b[i], acc) (``fold``), or dot = fma(a[i], b[i], dot)
    then acc = acc + w * dot.
    """
    CB, L, bs, _ = vals.shape
    s, t = B.shape
    a_all = vals.float()
    acc = torch.zeros((CB, bs, bt), dtype=torch.float32)
    for p in range(L):
        cb = torch.arange(CB)
        l = order[:, p].long()
        if plain:
            rb, grp = src[cb, l].long(), torch.zeros(CB, dtype=torch.long)
            w = torch.ones(CB, dtype=torch.float32)
        else:
            rb, grp = src[cb, l, 0].long(), src[cb, l, 1].long()
            w = wslot[cb, l].float()
        live = (w != 0) | plain
        a = a_all[cb, l]                                          # (CB, bs, bs)
        rows = rb[:, None] * bs + torch.arange(bs)[None]          # (CB, bs)
        cols = grp[:, None] * bt + torch.arange(bt)[None]         # (CB, bt)
        b = B.float()[rows[:, :, None], cols[:, None, :]]         # (CB, bs, bt)
        if fold:
            wa = (w[:, None, None] * a).float()
            new = acc
            for i in range(bs):
                new = _fma32(wa[:, i, :, None], b[:, i, None, :], new)
        else:
            dot = torch.zeros_like(acc)
            for i in range(bs):
                dot = _fma32(a[:, i, :, None], b[:, i, None, :], dot)
            new = (acc.double() + (w[:, None, None] * dot).double()).float()
        acc = torch.where(live[:, None, None], new, acc)
    return acc.reshape(CB * bs, bt)


def _close(got, want, what: str):
    want = np.asarray(want, dtype=np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * scale, err_msg=what)


def _keys(src: np.ndarray, bs_rows: int) -> np.ndarray:
    return src[..., 0].astype(np.int64) + (
        src[..., 1].astype(np.int64) * bs_rows if src.shape[-1] == 2 else 0)


# --------------------------------- the order --------------------------------

@pytest.mark.parametrize("width", [2, 1], ids=["fused", "plain"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_order_sorts_each_row_by_b_tile_stably(width, seed):
    rng = np.random.default_rng(seed)
    CB, L, bs_rows, groups = 5, 40, 6, 3             # few keys: many ties
    src = np.stack([rng.integers(0, bs_rows, (CB, L)),
                    rng.integers(0, groups, (CB, L))], -1)[..., :width].astype(np.int32)
    order = slot_order(torch.from_numpy(src), bs_rows)
    assert order.dtype == torch.int32 and tuple(order.shape) == (CB, L)
    o = order.numpy()
    keys = _keys(src, bs_rows)
    for cb in range(CB):
        assert sorted(o[cb]) == list(range(L))                     # a permutation
        walked = keys[cb, o[cb]]
        assert (np.diff(walked) >= 0).all()                        # by key
        for k in np.unique(walked):                                # stable: ties
            ties = o[cb][walked == k]                              # keep l order
            assert (np.diff(ties) > 0).all()


def test_slot_order_is_the_same_for_any_bs_rows_past_the_largest_row_block():
    rng = np.random.default_rng(3)
    src = torch.from_numpy(np.stack([rng.integers(0, 7, (4, 30)),
                                     rng.integers(0, 2, (4, 30))], -1).astype(np.int32))
    orders = [slot_order(src, bs_rows) for bs_rows in (7, 8, 1000)]
    assert all(torch.equal(orders[0], o) for o in orders[1:])
    assert slot_order(src[None].expand(3, -1, -1, -1), 7).shape == (3, 4, 30)


def _coded_op(compute_dtype: str = "float32"):
    rng = np.random.default_rng(11)
    s, r, t, bs = 64, 32, 24, 8
    mask = rng.random((s // bs, r // bs)) < 0.4
    A = (rng.standard_normal((s // bs, bs, r // bs, bs)).astype(np.float32)
         * mask[:, None, :, None]).reshape(s, r)
    B = torch.from_numpy(rng.standard_normal((s, t)).astype(np.float32))
    cfg = CodedMatmulConfig(scheme="sparse_code", backend="block_sparse",
                            block_size=bs, compute_dtype=compute_dtype)
    op = plan(cfg, m=2, n=2, num_workers=8, seed=0).bind("cpu")
    return op, dense_to_block_ell(A, bs), B, s // bs


def _rebinds(op):
    """A survivor rebind and a partial-straggler (chunk) rebind of op."""
    out = []
    for k in range(op.base_plan.num_workers):
        surv = np.ones(op.base_plan.num_workers, dtype=bool)
        surv[k] = False
        chunks = np.ones((op.base_plan.num_workers, 2), dtype=bool)
        chunks[k, 1] = False
        try:
            out = [op.with_survivors(surv), op.with_survivors(chunks)]
        except DecodingError:
            continue
        break
    assert out, "no decodable rebind"
    return out


@pytest.mark.parametrize("which", [0, 1], ids=["dead worker", "partial chunks"])
def test_order_is_unchanged_by_rebinds_and_still_walks_the_rebound_weights(which):
    """A rebind changes only the weights: the pack and its device copy
    stay, so the order the wrapper makes of its src stays; the kernel's walk
    over that order with the rebound weights still gives the plain
    version's product."""
    op, ell, B, bs_rows = _coded_op()
    dpack = pack_cache.device_pack(op.pack_for(ell), CPU)
    order = slot_order(dpack.src, bs_rows)
    rebound = _rebinds(op)[which]
    rebound_pack = pack_cache.device_pack(rebound.pack_for(ell), CPU)
    assert rebound_pack is dpack
    assert torch.equal(slot_order(rebound_pack.src, bs_rows), order)
    w_base = _block_sparse_operands(op.plan_, dpack)
    w_new = _block_sparse_operands(rebound.plan_, dpack)
    # a dead worker leaves the weights (its decode column goes to 0); a
    # partial straggler's unfinished slots go to weight 0
    assert torch.equal(w_base, w_new) == (which == 0)
    bt = B.shape[1] // op.base_plan.n
    for k in range(op.base_plan.num_workers):
        got = emulate_slot_loop(dpack.vals[k], dpack.src[k], w_new[k], B, bt,
                                order[k])
        want = ref.spmm_block_fused_ref(dpack.vals[k], dpack.src[k], w_new[k], B, bt)
        scale = max(float(want.abs().max()), 1e-30)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=RTOL * scale, err_msg=f"worker {k}")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "int8"])
def test_wrapper_order_walks_every_worker_pack_in_b_address_order(compute_dtype):
    """The order the wrapper makes, slot_order(src, s // bs), on each
    worker's packed src: a permutation of each column block's slots that
    walks B's tiles in address order, the same as with the least key base
    the pack admits."""
    op, ell, B, bs_rows = _coded_op(compute_dtype)
    dpack = pack_cache.device_pack(op.pack_for(ell), CPU)
    least = int(dpack.src[..., 0].max()) + 1
    for k in range(op.base_plan.num_workers):
        order = slot_order(dpack.src[k], bs_rows)
        assert order.dtype == torch.int32 and order.shape == dpack.wslot[k].shape
        assert torch.equal(order, slot_order(dpack.src[k], least))
        assert torch.equal(order.sort(dim=1).values,
                           torch.arange(order.shape[1]).expand_as(order).int())
        keys = dpack.src[k][..., 1].long() * bs_rows + dpack.src[k][..., 0].long()
        walked = keys.gather(1, order.long())
        assert bool((walked[:, 1:] >= walked[:, :-1]).all())


@pytest.mark.parametrize("t,offset,want", [
    (8192, 0, "tma"), (753, 0, "cp_async_4"), (120, 1, "cp_async_4"),
    (120, 4, "tma")], ids=["full width", "ragged row", "start off 16 B",
                           "start on 16 B"])
def test_copy_path_takes_the_copy_engine_only_on_16_bytes(t, offset, want):
    """The copy engine needs B's rows (t f32) and its start on 16 bytes; any
    other B goes by 4-byte copies.  offset: elements into a 16-byte aligned
    buffer where B starts."""
    buf = torch.empty(4 * t + 16, dtype=torch.float32)
    skip = (-buf.data_ptr() % 16) // 4 + offset
    B = buf[skip:skip + 4 * t].view(4, t)
    assert B.is_contiguous() and copy_path(B) == want


# ------------------------ the kernel's summation order ----------------------

def _case(seed: int, bs: int, bt: int, dtype: str, CB=2, L=3, s=32, n=2, mn=4):
    """test_torch_kernels.py's operands: tiles rounded to ``dtype`` (bf16 as
    its exact f32 upcast), one padded slot per column block."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((CB, L, bs, bs)).astype(np.float32)
    if dtype == "bfloat16":
        vals = np.array(jnp.asarray(vals, jnp.bfloat16).astype(jnp.float32))
    elif dtype == "int8":
        vals = np.clip(np.rint(vals * 40), -127, 127).astype(np.int8)
    src = np.stack([rng.integers(0, s // bs, (CB, L)),
                    rng.integers(0, n, (CB, L))], -1).astype(np.int32)
    w = rng.standard_normal((CB, L)).astype(np.float32)
    w[:, -1] = 0.0
    dvec = rng.standard_normal(mn).astype(np.float32)
    B = rng.standard_normal((s, n * bt)).astype(np.float32)
    return vals, src, w, dvec, B


@pytest.mark.parametrize("bt,t_tile", [(24, 24), (40, 8), (251, 251)])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_kernel_summation_order_matches_pallas_and_oracle(bt, t_tile, bs, dtype):
    seed = 1000 * bt + 10 * bs + ("float32", "bfloat16", "int8").index(dtype)
    vals, src, w, dvec, B = _case(seed, bs, bt, dtype)
    jv = jnp.asarray(vals, jnp.bfloat16 if dtype == "bfloat16" else None)
    js, jw, jd, jB = map(jnp.asarray, (src, w, dvec, B))
    pv = torch.from_numpy(vals)
    ps, pw, pd, pB = map(torch.from_numpy, (src, w, dvec, B))
    order = slot_order(ps, B.shape[0] // bs)

    pallas = _spmm_block_fused_pallas(jv, js, jw, jB, bt=bt, t_tile=t_tile,
                                      interpret=True)
    pallas_decode = _spmm_block_fused_decode_pallas(jv, js, jw, jd, jB, bt=bt,
                                                    t_tile=t_tile, interpret=True)
    oracle = jax_ref.spmm_block_fused_ref(jv, js, jw, jB, bt)
    for fold in (True, False):
        two = emulate_slot_loop(pv, ps, pw, pB, bt, order, fold=fold)
        what = f"fold={fold}"
        _close(two, pallas, f"Pallas fused, {what}")
        _close(two, oracle, f"jnp oracle, {what}")
        # the decode epilogue scales the same sum: dvec (x) two-step
        _close(pd[:, None, None] * two[None], pallas_decode,
               f"Pallas fused decode, {what}")


#: (bs, RB, CB, t, density) of the JAX package's spmm_block sweep
SPMM_SHAPES = [(8, 4, 4, 128, 0.3), (8, 8, 2, 256, 0.1), (16, 4, 4, 128, 0.5),
               (8, 2, 8, 128, 0.9)]


@pytest.mark.parametrize("bs,RB,CB,t,density", SPMM_SHAPES)
def test_plain_summation_order_matches_pallas_spmm_block(bs, RB, CB, t, density):
    rng = np.random.default_rng(1000 * bs + 100 * RB + 10 * CB + t)
    mask = rng.random((RB, CB)) < density
    A = rng.standard_normal((RB * bs, CB * bs)) * np.kron(mask, np.ones((bs, bs)))
    ell = jax_dense_to_block_ell(A.astype(np.float32), block_size=bs)
    vals, idx = np.asarray(ell.vals, np.float32), np.asarray(ell.idx, np.int32)
    B = rng.standard_normal((RB * bs, t)).astype(np.float32)
    pidx = torch.from_numpy(idx)
    order = slot_order(pidx[..., None], RB)
    got = emulate_slot_loop(torch.from_numpy(vals), pidx, None, torch.from_numpy(B),
                            t, order, plain=True)
    jv, ji, jB = map(jnp.asarray, (vals, idx, B))
    _close(got, jax_spmm_block(jv, ji, jB, t_tile=128, interpret=True),
           "Pallas spmm_block")
    _close(got, jax_ref.spmm_block_ref(jv, ji, jB, out_rows=CB * bs), "jnp oracle")


# ------------------------- the build's ptxas report -------------------------

def test_a_library_found_built_keeps_its_ptxas_report(tmp_path, monkeypatch):
    """chip_smoke.py reads the registers and spills of each kernel instance
    from ptxas's report; a second process that finds the library built
    reads the report kept beside it."""
    import stat
    import sys

    from repro_torch.kernels import build

    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n"
        "print(\"ptxas info    : Used 87 registers\")\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "BUILD_LOG", {})
    first = build.build("spmm_block")
    assert "Used 87 registers" in build.BUILD_LOG["spmm_block"]
    monkeypatch.setattr(build, "BUILD_LOG", {})          # a new process
    assert build.build("spmm_block") == first
    assert "Used 87 registers" in build.BUILD_LOG["spmm_block"]
