"""Plain PyTorch versions of the CUDA kernels.

These define the semantics the kernels must reproduce.  They run wherever
the tensors lie: the CPU lane of ``repro_torch.kernels.ops`` calls them,
and ``chip_smoke.py`` holds each kernel against them on the card.  The
block-sparse ones are the gather + einsum of the JAX package's XLA lane
(``_spmm_block_fused_jnp``), the dense one the slot loop of its oracle
(``src/repro/kernels/ref.py``); none is a yardstick of speed.
"""

from __future__ import annotations

import torch

#: elements of the (cb, L, bs, bt) gathered intermediate per step: the
#: column blocks are independent, so they are taken in steps that keep the
#: intermediate near 1 GiB of f32 however large the operands
_STEP_ELEMS = 1 << 28


def spmm_block_fused_ref(vals: torch.Tensor, src: torch.Tensor,
                         wslot: torch.Tensor, B: torch.Tensor,
                         bt: int) -> torch.Tensor:
    """Fused-gather semantics: C[cb] = sum_l w[cb,l] * vals[cb,l]^T @
    B[src_rb rows, src_jb-th bt-wide column group].

    vals: (CB, L, bs, bs) f32/bf16/int8; src: (CB, L, 2) [row-block, column
    group]; wslot: (CB, L); B: (s, t), t divisible by bt.  Returns
    (CB * bs, bt) f32.
    """
    CB, L, bs, _ = vals.shape
    s, t = B.shape
    B4 = B.reshape(s // bs, bs, t // bt, bt)
    out = torch.empty((CB, bs, bt), dtype=torch.float32, device=B.device)
    step = max(1, _STEP_ELEMS // max(1, L * bs * bt))
    for lo in range(0, CB, step):
        sl = slice(lo, lo + step)
        rb = src[sl, :, 0].long()
        grp = src[sl, :, 1].long()
        bsel = B4[rb, :, grp, :].float()                        # (c, L, bs, bt)
        scaled = vals[sl].float() * wslot[sl, :, None, None].float()
        out[sl] = torch.einsum("clio,clit->cot", scaled, bsel)
    return out.reshape(CB * bs, bt)


def spmm_block_fused_decode_ref(vals: torch.Tensor, src: torch.Tensor,
                                wslot: torch.Tensor, dvec: torch.Tensor,
                                B: torch.Tensor, bt: int) -> torch.Tensor:
    """The decode-fused local product: out[c] = dvec[c] * C~, (mn, CB*bs, bt)
    f32 -- the two steps of the JAX package's ``_spmm_block_fused_decode_jnp``
    in the same order."""
    out = spmm_block_fused_ref(vals, src, wslot, B, bt)
    return dvec.float()[:, None, None] * out[None]


def spmm_block_ref(vals: torch.Tensor, idx: torch.Tensor,
                   B: torch.Tensor) -> torch.Tensor:
    """C = A^T B with A in block-ELL: C[cb] = sum_l vals[cb,l]^T @
    B[idx[cb,l] rows], (CB * bs, t) f32.

    The fused form with w = 1 and one column group of width t (a product by
    1.0 is exact), so it steps over the column blocks the same way.  Pad
    slots hold zero tiles and add nothing.
    """
    src = torch.stack([idx, torch.zeros_like(idx)], dim=-1)
    ones = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    return spmm_block_fused_ref(vals, src, ones, B, B.shape[1])


def coded_accum_ref(A: torch.Tensor, B: torch.Tensor, cols: torch.Tensor,
                    weights: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """C~ = sum_l weights[l] * A_{i_l}^T B_{j_l} with (i, j) =
    divmod(cols[l], n): A (s, r), B (s, t), (r/m, t/n) f32, summed slot by
    slot.  Padded slots carry weight 0 and add nothing."""
    r, t = A.shape[1], B.shape[1]
    br, bt = r // m, t // n
    acc = torch.zeros((br, bt), dtype=torch.float32, device=B.device)
    for col, w in zip(cols.tolist(), weights.float().tolist()):
        i, j = divmod(col, n)
        prod = A[:, i * br:(i + 1) * br].float().T @ B[:, j * bt:(j + 1) * bt].float()
        acc = acc + w * prod
    return acc
