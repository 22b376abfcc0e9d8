"""The port's fused SpMM kernels, through their CPU lane, against the JAX package.

The port's plain versions (``repro_torch.kernels.ref``, reached through
``kernels.ops`` with CPU tensors) must agree with all three of the JAX
package's forms of the same two functions, fed the same arrays:

* the Pallas kernels ``_spmm_block_fused_pallas`` /
  ``_spmm_block_fused_decode_pallas``, run by the Pallas interpreter;
* the XLA lane ``_spmm_block_fused_jnp`` / ``_spmm_block_fused_decode_jnp``;
* the oracle ``repro.kernels.ref.spmm_block_fused_ref``.

Tolerance: all of them compute in f32 from the same (bf16- or int8-valued)
tiles, and differ only in the order of the f32 sums over the L * bs terms
of each output (a slot loop vs an einsum), so they agree to about 1e-5 of
the largest output.  On the port, the decode form must equal dvec (x) the
two-step form bitwise.  The CUDA kernels themselves run only on the card
(``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.spmm_block import (  # noqa: E402
    _spmm_block_fused_decode_jnp,
    _spmm_block_fused_decode_pallas,
    _spmm_block_fused_jnp,
    _spmm_block_fused_pallas,
)

from repro_torch.kernels import ops, ref  # noqa: E402

RTOL = 1e-5


def _case(seed: int, bs: int, bt: int, dtype: str, CB=2, L=3, s=32, n=2, mn=4):
    """Operands as numpy arrays, with tiles already rounded to ``dtype``
    (bf16 carried as its exact f32 upcast), and one padded slot."""
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


def _jax_vals(vals: np.ndarray, dtype: str):
    return jnp.asarray(vals, jnp.bfloat16 if dtype == "bfloat16" else None)


def _port_vals(vals: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(vals)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _close(got, want, what: str):
    want = np.asarray(want, dtype=np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * scale, err_msg=what)


#: (bt, Pallas t_tile): a ragged bt, a bt tiled by a small t_tile, a prime bt
BT_TILES = [(24, 24), (40, 8), (251, 251)]


@pytest.mark.parametrize("bt,t_tile", BT_TILES)
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_port_fused_matches_every_jax_form(bt, t_tile, bs, dtype):
    seed = 1000 * bt + 10 * bs + ("float32", "bfloat16", "int8").index(dtype)
    vals, src, w, dvec, B = _case(seed, bs, bt, dtype)
    jv = _jax_vals(vals, dtype)
    js, jw, jd, jB = map(jnp.asarray, (src, w, dvec, B))
    pv = _port_vals(vals, dtype)
    ps, pw, pd, pB = map(torch.from_numpy, (src, w, dvec, B))

    two = ops.spmm_block_fused(pv, ps, pw, pB, bt=bt)
    fused = ops.spmm_block_fused_decode(pv, ps, pw, pd, pB, bt=bt)
    assert two.shape == (src.shape[0] * bs, bt) and two.dtype == torch.float32
    assert fused.shape == (len(dvec), src.shape[0] * bs, bt)
    # the decode form is dvec (x) the two-step form, bit for bit
    assert torch.equal(fused, pd[:, None, None] * two[None])

    _close(two, _spmm_block_fused_pallas(jv, js, jw, jB, bt=bt, t_tile=t_tile,
                                         interpret=True), "Pallas fused")
    _close(fused, _spmm_block_fused_decode_pallas(
        jv, js, jw, jd, jB, bt=bt, t_tile=t_tile, interpret=True),
        "Pallas fused decode")
    _close(two, _spmm_block_fused_jnp(jv, js, jw, jB, bt=bt), "XLA fused")
    _close(fused, _spmm_block_fused_decode_jnp(jv, js, jw, jd, jB, bt=bt),
           "XLA fused decode")
    _close(two, jax_ref.spmm_block_fused_ref(jv, js, jw, jB, bt), "jnp oracle")


def test_plain_version_steps_over_column_blocks_without_changing_results(monkeypatch):
    """The plain version takes the column blocks in steps that bound its
    gathered intermediate; every step size gives the same result."""
    vals, src, w, _, B = _case(3, 8, 24, "float32", CB=5, L=4)
    args = [torch.from_numpy(a) for a in (vals, src, w, B)]
    whole = ref.spmm_block_fused_ref(*args, 24)
    monkeypatch.setattr(ref, "_STEP_ELEMS", 2 * 4 * 8 * 24)   # two blocks a step
    stepped = ref.spmm_block_fused_ref(*args, 24)
    np.testing.assert_allclose(stepped.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6 * float(whole.abs().max()))
