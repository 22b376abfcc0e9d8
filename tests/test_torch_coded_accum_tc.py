"""The arithmetic of the tensor-core ``coded_accum`` kernel, emulated on the
CPU, against the port's plain version and the JAX package's kernel.

The CUDA kernel (``src/repro_torch/kernels/csrc/coded_accum.cu``) runs only
on the card.  What it does to the numbers is written out here in plain
torch: every f32 operand x is split into big = rna_tf32(x) (round to
nearest, ties away from zero, by bit operations, as ``cvt.rna.tf32.f32``
does) and small = x - big, which the MMA reads truncated to TF32, and each
slot's product over s is the sum of three products of TF32 values, small
terms first: a_small^T b_big + a_big^T b_small + a_big^T b_big.  A bf16
operand is exact in TF32, so its small part is 0 and its cross term is not
formed.  A
product of two TF32 values is exact in f32, so an f32 matmul of the split
operands forms the same products as the MMAs.  The sum runs in spans of 128
rows of s that are then added in order, as the kernel promotes its MMA sum;
the tensor cores' own rounding inside a span is the hardware's and is not
emulated (``chip_smoke.py`` holds the kernel itself against the plain
version on the card).

Tolerance: ``sum_tol`` of ``chip_smoke.py``, 8 sqrt(K) eps of the largest
output for K = s * L summed terms, the bound the kernel is held to on the
card.  One TF32 pass misses it at s = 16384; three keep it.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.coded_accum import coded_accum as jax_coded_accum  # noqa: E402

from repro_torch.kernels import coded_accum, ops, ref  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)
SPAN = 128          # rows of s the kernel's MMAs sum before a promotion


def sum_tol(K: int, scale: float) -> float:
    return 8.0 * math.sqrt(K) * EPS32 * max(scale, 1e-30)


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
    add half of the 13 dropped bits to the magnitude's bit pattern, then
    clear them."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """x truncated to TF32: the 13 low bits cleared, as the MMA reads a TF32
    operand."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def _split(x: torch.Tensor, exact: bool):
    big = rna_tf32(x)
    return big, None if exact else trunc_tf32(x - big)


def emulate(A: torch.Tensor, B: torch.Tensor, cols, weights, m: int, n: int,
            passes: int = 3) -> torch.Tensor:
    """The kernel's sum, C~ = sum_l w_l A_{i_l}^T B_{j_l}, in TF32 passes:
    three for f32 x f32 (one if ``passes`` is 1), fewer where an operand is
    bf16."""
    r, t = A.shape[1], B.shape[1]
    br, bt = r // m, t // n
    exact_a = passes == 1 or A.dtype == torch.bfloat16
    exact_b = passes == 1 or B.dtype == torch.bfloat16
    out = torch.zeros((br, bt), dtype=torch.float32)
    for c, w in zip(np.asarray(cols).tolist(), np.asarray(weights).tolist()):
        if w == 0.0:
            continue
        i, j = divmod(c, n)
        a = A[:, i * br:(i + 1) * br].float()
        b = B[:, j * bt:(j + 1) * bt].float()
        tot = torch.zeros((br, bt), dtype=torch.float32)
        for k0 in range(0, a.shape[0], SPAN):
            a_big, a_small = _split(a[k0:k0 + SPAN], exact_a)
            b_big, b_small = _split(b[k0:k0 + SPAN], exact_b)
            acc = torch.zeros_like(tot)
            if a_small is not None:
                acc = acc + a_small.T @ b_big
            if b_small is not None:
                acc = acc + a_big.T @ b_small
            tot = tot + (acc + a_big.T @ b_big)
        out = out + np.float32(w) * tot
    return out


# ------------------------------ TF32 rounding -------------------------------

@pytest.mark.parametrize("x, want", [
    (1.0, 1.0),
    (1.0 + 2.0**-12, 1.0),                      # below half an ulp: down
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),           # a tie: away from zero
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 2.0**-10 + 2.0**-11 - 2.0**-23, 1.0 + 2.0**-10),
    (2.0 - 2.0**-23, 2.0),                      # carries into the exponent
    (0.0, 0.0),
], ids=["one", "down", "tie", "negative-tie", "below-tie", "carry", "zero"])
def test_rna_tf32_rounds_to_ten_mantissa_bits_ties_away(x, want):
    got = rna_tf32(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want


def test_rna_tf32_keeps_bf16_values():
    """A bf16 value has 7 mantissa bits: TF32 holds it exactly, so its small
    part is 0 and the kernel does not issue its cross term."""
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    assert torch.equal(rna_tf32(x.float()), x.float())


# ------------------ emulation vs the port and the JAX kernel ----------------

#: (m, n, s, r, t, L) of the JAX package's coded_accum sweep
ACCUM_SHAPES = [
    (2, 2, 128, 16, 24, 3),
    (2, 2, 256, 32, 32, 5),
    (4, 2, 128, 32, 16, 7),
    (1, 4, 128, 8, 32, 2),
    (3, 3, 384, 24, 36, 4),
]


def _operands(rng, m, n, s, r, t, L, dtype):
    A = torch.from_numpy(rng.standard_normal((s, r), dtype=np.float32)).to(dtype)
    B = torch.from_numpy(rng.standard_normal((s, t), dtype=np.float32)).to(dtype)
    cols = rng.integers(0, m * n, size=L).astype(np.int32)
    w = rng.standard_normal(L).astype(np.float32)
    w[-1] = 0.0                                   # a padded slot
    return A, B, cols, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,s,r,t,L", ACCUM_SHAPES)
def test_3xtf32_emulation_matches_port_and_pallas(dtype, m, n, s, r, t, L):
    rng = np.random.default_rng(31 * s + 7 * r + t + L)
    A, B, cols, w = _operands(rng, m, n, s, r, t, L, dtype)
    got = emulate(A, B, cols, w, m, n)
    port = ops.coded_accum(A, B, torch.from_numpy(cols), torch.from_numpy(w),
                           m=m, n=n)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    pallas = np.asarray(jax_coded_accum(
        jnp.asarray(A.float().numpy(), jdt), jnp.asarray(B.float().numpy(), jdt),
        jnp.asarray(cols), jnp.asarray(w), m=m, n=n, s_chunk=128, interpret=True))
    assert got.shape == (r // m, t // n)
    for name, want in (("port's plain version", port.numpy()), ("Pallas", pallas)):
        tol = sum_tol(s * L, float(np.abs(want).max()))
        err = float(np.abs(got.numpy() - want).max())
        assert err <= tol, f"3xTF32 vs {name}: {err} > {tol}"


@pytest.mark.parametrize("passes, inside", [(3, True), (1, False)],
                         ids=["3xTF32", "1xTF32"])
def test_three_passes_keep_sum_tol_at_full_depth(passes, inside):
    """At the main path's depth s = 16384 (one slot, a narrow 64 x 64
    block), 3xTF32 stays far inside the kernel's tolerance against the f32
    plain version, and one TF32 pass does not: the reason the kernel issues
    three MMAs a step for f32 operands."""
    rng = np.random.default_rng(0)
    m = n = 1
    A, B, cols, w = _operands(rng, m, n, 16384, 64, 64, 2, torch.float32)
    w[0], w[1] = 1.0, 0.0
    plain = ref.coded_accum_ref(A, B, torch.from_numpy(cols), torch.from_numpy(w), m, n)
    tol = sum_tol(16384 * 2, float(plain.abs().max()))
    err = float((emulate(A, B, cols, w, m, n, passes=passes) - plain).abs().max())
    assert (err <= tol) == inside, f"{passes}xTF32: err {err}, tol {tol}"
    if inside:
        assert err <= tol / 20


# ------------------------------ the copy path -------------------------------

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("a_dtype, b_dtype, r, t, br, bt, a_addr, want", [
    # the JAX sweep's shapes (the tests' shapes), f32: every row and block
    # on 16 bytes
    (F32, F32, 16, 24, 8, 12, 0, "wide"),
    (F32, F32, 32, 32, 16, 16, 0, "wide"),
    (F32, F32, 32, 16, 8, 8, 0, "wide"),
    (F32, F32, 8, 32, 8, 8, 0, "wide"),
    (F32, F32, 24, 36, 8, 12, 0, "wide"),
    # bf16: bt = 12 is 24 bytes, no whole 16-byte copy
    (BF16, BF16, 16, 24, 8, 12, 0, "narrow"),
    (BF16, BF16, 32, 32, 16, 16, 0, "wide"),
    (BF16, BF16, 32, 16, 8, 8, 0, "wide"),
    (BF16, BF16, 8, 32, 8, 8, 0, "wide"),
    (BF16, BF16, 24, 36, 8, 12, 0, "narrow"),
    # the main path's width
    (F32, F32, 8192, 8192, 4096, 4096, 0, "wide"),
    (BF16, BF16, 8192, 8192, 4096, 4096, 0, "wide"),
    # chip_smoke's tile cases: ragged edges on 16 bytes, and off them
    (F32, F32, 400, 272, 200, 136, 0, "wide"),
    (F32, F32, 402, 266, 201, 133, 0, "narrow"),
    (F32, BF16, 400, 272, 200, 136, 0, "wide"),
    (BF16, F32, 402, 266, 201, 133, 0, "narrow"),
    # a row of 16 bytes but a block of 8 (f32 br = 2), or A off 16 bytes
    (F32, F32, 4, 8, 2, 4, 0, "narrow"),
    (F32, F32, 8192, 8192, 4096, 4096, 4, "narrow"),
])
def test_copy_path_choice(a_dtype, b_dtype, r, t, br, bt, a_addr, want):
    assert coded_accum.copy_path(a_dtype, b_dtype, r, t, br, bt, a_addr, 0) == want
