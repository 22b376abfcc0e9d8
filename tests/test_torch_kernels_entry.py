"""The port's kernel entry points ``spmm_block`` and ``coded_accum``, through
their CPU lane, against the JAX package.

The port's ``kernels.ops.spmm_block`` / ``ops.coded_accum`` on CPU tensors
(their plain versions in ``repro_torch.kernels.ref``) must agree with the
JAX package's Pallas kernels (``src/repro/kernels/spmm_block.py``,
``src/repro/kernels/coded_accum.py``), run by the Pallas interpreter, and
with its oracles (``src/repro/kernels/ref.py``), fed the same arrays, at the
shapes and dtypes of the JAX package's own kernel tests.

Tolerance: every form computes in f32 from the same (bf16-valued) inputs
and differs only in the order of the f32 sums over the s * L (or L * bs)
terms of each output, so they agree to about 1e-5 of the largest output.
The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""

from __future__ import annotations

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.coded_accum import coded_accum as jax_coded_accum  # noqa: E402
from repro.kernels.spmm_block import spmm_block as jax_spmm_block  # noqa: E402
from repro.sparse import dense_to_block_ell  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402

RTOL = 1e-5
DTYPES = ["float32", "bfloat16"]


def _round(x: np.ndarray, dtype: str) -> np.ndarray:
    """f32 values already rounded to ``dtype`` (bf16 as its exact upcast)."""
    x = x.astype(np.float32)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


def _jax(x: np.ndarray, dtype: str):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _port(x: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _close(got, want, what: str):
    want = np.asarray(want, dtype=np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * scale, err_msg=what)


# ----------------------------- coded_accum --------------------------------

#: (m, n, s, r, t, L) of the JAX package's coded_accum sweep
ACCUM_SHAPES = [
    (2, 2, 128, 16, 24, 3),
    (2, 2, 256, 32, 32, 5),
    (4, 2, 128, 32, 16, 7),
    (1, 4, 128, 8, 32, 2),
    (3, 3, 384, 24, 36, 4),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,s,r,t,L", ACCUM_SHAPES)
def test_port_coded_accum_matches_pallas_and_oracle(dtype, m, n, s, r, t, L):
    rng = np.random.default_rng(97 * s + 13 * r + 7 * t + L)
    A = _round(rng.standard_normal((s, r)), dtype)
    B = _round(rng.standard_normal((s, t)), dtype)
    cols = rng.integers(0, m * n, size=L).astype(np.int32)
    w = rng.standard_normal(L).astype(np.float32)
    w[-1] = 0.0                                   # a padded slot
    got = ops.coded_accum(_port(A, dtype), _port(B, dtype),
                          torch.from_numpy(cols), torch.from_numpy(w),
                          m=m, n=n, s_chunk=128)
    assert got.shape == (r // m, t // n) and got.dtype == torch.float32
    jA, jB, jc, jw = _jax(A, dtype), _jax(B, dtype), jnp.asarray(cols), jnp.asarray(w)
    _close(got, jax_coded_accum(jA, jB, jc, jw, m=m, n=n, s_chunk=128,
                                interpret=True), "Pallas coded_accum")
    _close(got, jax_ref.coded_accum_ref(jA, jB, jc, jw, m=m, n=n), "jnp oracle")


# ----------------------------- spmm_block ---------------------------------

#: (bs, RB, CB, t, density) of the JAX package's spmm_block sweep
SPMM_SHAPES = [
    (8, 4, 4, 128, 0.3),
    (8, 8, 2, 256, 0.1),
    (16, 4, 4, 128, 0.5),
    (8, 2, 8, 128, 0.9),
]


def _block_ell(rng, bs, RB, CB, density, dtype):
    mask = rng.random((RB, CB)) < density
    A = rng.standard_normal((RB * bs, CB * bs)) * np.kron(mask, np.ones((bs, bs)))
    ell = dense_to_block_ell(A, block_size=bs)
    return _round(ell.vals, dtype), ell.idx.astype(np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs,RB,CB,t,density", SPMM_SHAPES)
def test_port_spmm_block_matches_pallas_and_oracle(dtype, bs, RB, CB, t, density):
    rng = np.random.default_rng(1000 * bs + 100 * RB + 10 * CB + t)
    vals, idx = _block_ell(rng, bs, RB, CB, density, dtype)
    B = _round(rng.standard_normal((RB * bs, t)), dtype)
    got = ops.spmm_block(_port(vals, dtype), torch.from_numpy(idx),
                         _port(B, dtype), t_tile=128)
    assert got.shape == (CB * bs, t) and got.dtype == torch.float32
    jv, ji, jB = _jax(vals, dtype), jnp.asarray(idx), _jax(B, dtype)
    _close(got, jax_spmm_block(jv, ji, jB, t_tile=128, interpret=True),
           "Pallas spmm_block")
    _close(got, jax_ref.spmm_block_ref(jv, ji, jB, out_rows=CB * bs), "jnp oracle")


def test_plain_spmm_block_steps_over_column_blocks_without_changing_results(
        monkeypatch):
    """The plain version takes the column blocks in steps that bound its
    gathered intermediate; a small step gives the same result."""
    rng = np.random.default_rng(5)
    vals, idx = _block_ell(rng, 8, 6, 5, 0.6, "float32")
    B = rng.standard_normal((48, 40)).astype(np.float32)
    args = (torch.from_numpy(vals), torch.from_numpy(idx), torch.from_numpy(B))
    whole = ref.spmm_block_ref(*args)
    L = vals.shape[1]
    monkeypatch.setattr(ref, "_STEP_ELEMS", 2 * L * 8 * 40)   # two blocks a step
    stepped = ref.spmm_block_ref(*args)
    np.testing.assert_allclose(stepped.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6 * float(whole.abs().max()))


# ------------------------- the same ValueErrors -----------------------------

def _bad_s_chunk():
    A, B = np.ones((100, 8), np.float32), np.ones((100, 8), np.float32)
    cols, w = np.zeros(2, np.int32), np.ones(2, np.float32)
    return (lambda: jax_coded_accum(jnp.asarray(A), jnp.asarray(B), jnp.asarray(cols),
                                    jnp.asarray(w), m=2, n=2, s_chunk=128,
                                    interpret=True),
            lambda: ops.coded_accum(*map(torch.from_numpy, (A, B, cols, w)),
                                    m=2, n=2, s_chunk=128))


def _spmm_operands(s, t, bs=8):
    vals = np.ones((2, 1, bs, bs), np.float32)
    idx = np.zeros((2, 1), np.int32)
    return vals, idx, np.ones((s, t), np.float32)


def _bad_t_tile():
    vals, idx, B = _spmm_operands(16, 100)
    return (lambda: jax_spmm_block(*map(jnp.asarray, (vals, idx, B)), t_tile=128,
                                   interpret=True),
            lambda: ops.spmm_block(*map(torch.from_numpy, (vals, idx, B)),
                                   t_tile=128))


def _bad_bs():
    vals, idx, B = _spmm_operands(20, 128)
    return (lambda: jax_spmm_block(*map(jnp.asarray, (vals, idx, B)), t_tile=128,
                                   interpret=True),
            lambda: ops.spmm_block(*map(torch.from_numpy, (vals, idx, B)),
                                   t_tile=128))


@pytest.mark.parametrize("case", [_bad_s_chunk, _bad_t_tile, _bad_bs],
                         ids=["s_chunk", "t_tile", "bs"])
def test_both_packages_raise_the_same_value_error(case):
    jax_call, port_call = case()
    with pytest.raises(ValueError) as jax_err:
        jax_call()
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        port_call()
