"""Gradient compression: top-k sparsification with error feedback, and
coded sparse aggregation.

Top-k with error feedback keeps the largest fraction of each gradient
leaf and carries the rest into the next step.  Sparsified gradients are
the regime the paper targets (nnz << size), so ``coded_aggregate`` sums
them through the (P, S)-sparse code: the sum is cut into mn chunks, N
aggregators each combine their coded chunks, and any full-rank subset of
them gives the sum back through the hybrid peeling/rooting decoder.  It
simulates that protocol on one device, as the reference simulates it on
the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.blocks import resolve_device
from repro_torch.core.decoder import hybrid_decode
from repro_torch.core.encoder import SparseCodeSpec, generate_coefficient_matrix, make_tasks
from repro_torch.training.tree import tree_leaves, tree_map, tree_unflatten


def topk_sparsify(tree: dict, frac: float):
    """Keep the top ``frac`` of each leaf's entries by magnitude: every
    entry at least the k-th largest |g| (ties kept, as ``jax.lax.top_k``'s
    threshold keeps them).  Returns (sparse_tree, residual_tree)."""
    def one(g):
        k = max(1, int(g.numel() * frac))
        thresh = torch.topk(g.reshape(-1).abs(), k).values[-1]
        mask = (g.abs() >= thresh).to(g.dtype)
        return g * mask, g * (1 - mask)

    pairs = [one(g) for g in tree_leaves(tree)]
    return (tree_unflatten(tree, [a for a, _ in pairs]),
            tree_unflatten(tree, [b for _, b in pairs]))


def error_feedback_update(grads: dict, residual: dict | None, frac: float):
    """grads + carried residual -> (compressed grads, new residual)."""
    if residual is None:
        residual = tree_map(torch.zeros_like, grads)
    corrected = tree_map(lambda g, r: g + r.to(g.dtype), grads, residual)
    return topk_sparsify(corrected, frac)


def encode_chunks(chunks: torch.Tensor, M) -> list[torch.Tensor]:
    """Each row k of the code's coefficient matrix M as the float64 vector
    sum_c M[k, c] chunks[c].

    The weights are integers up to (mn)^2, so an f32 chunk's products are
    exact in float64 and their sums all but exact: the hybrid decode gives
    the f32 chunks back to within float64 rounding.  The reference rounds
    each sum to f32, whose coded values reach (mn)^2 times the chunks'; at
    mn = 16 its restore is off by up to about 1e-3 of the largest value
    (ROADMAP queue 3)."""
    chunks = chunks.double()
    out = []
    for task in make_tasks(M):
        acc = torch.zeros(chunks.shape[1], dtype=torch.float64, device=chunks.device)
        for c, w in zip(task.cols, task.weights):
            acc += float(w) * chunks[c]
        out.append(acc)
    return out


def coded_aggregate(grad_shards, *, m: int = 2, n: int = 2,
                    num_workers: int | None = None, seed: int = 0,
                    survivors: list[int] | None = None, device=None):
    """Sum sparse gradient shards through the (P, S)-sparse code.

    grad_shards: per-pod flat gradient vectors (numpy arrays or tensors),
    summed in order as a plain all-reduce would.  The sum is cut into mn
    chunks; each of N aggregators combines its coded chunks (float64,
    ``encode_chunks``); the survivors (all by default) decode the sum with
    ``hybrid_decode``.
    Runs on ``device`` (None: the CUDA card, raising where there is none).
    Returns (the sum as an f32 tensor, decode stats); a survivor set that
    loses rank raises ``DecodingError``."""
    device = resolve_device(device)
    shards = [torch.as_tensor(s, device=device) for s in grad_shards]
    total = shards[0].clone()
    for s in shards[1:]:  # numpy's order for a sum over axis 0
        total += s
    d = m * n
    pad = (-total.numel()) % d
    chunks = F.pad(total, (0, pad)).reshape(d, -1)

    N = num_workers or (d + 4)
    M = generate_coefficient_matrix(SparseCodeSpec(m=m, n=n, num_workers=N, seed=seed))
    results = encode_chunks(chunks, M)

    rows = sorted(survivors) if survivors is not None else list(range(N))
    blocks, stats = hybrid_decode(M[rows], [results[r] for r in rows])
    out = torch.cat(blocks).float()
    if pad:
        out = out[:-pad]
    return out, stats
