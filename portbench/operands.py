"""The operands of a run, drawn from ``--seed`` on the device.

A and B are sparse: each has exactly ``nnz_a`` / ``nnz_b`` nonzeros, at
places drawn uniformly without replacement, with standard normal values.
The seed moves where the nonzeros lie and what they hold; how many there
are is the configuration's.  The port's block-sparse path takes A as a
dense tensor beside its block-ELL (the live ``block_size`` tiles of each
column block) and B as a dense tensor, so both are held dense as well.

Everything is drawn on the run's device with one seeded ``torch.Generator``
in a few large calls; only A's block-ELL goes to the host, where the
port's API wants it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Operands:
    #: dense A (s, r) f32 and B (s, t) f32 on the device: the inputs the
    #: port's ``CodedOp.apply`` and the reference both take
    A: torch.Tensor
    B: torch.Tensor
    #: A's live tiles as a block-ELL on the device: each column block's
    #: row blocks ``rows`` (CB, L) in ascending order, the first ``nnzb``
    #: (CB,) of them live (the rest 0), and their values ``vals``
    #: (CB, L, bs, bs)
    vals: torch.Tensor
    rows: torch.Tensor
    nnzb: torch.Tensor

    @property
    def live_tiles(self) -> int:
        return int(self.nnzb.sum())


def geometry(config: dict) -> tuple[int, int, int, int]:
    """(s, r, t, bs) of a configuration, checked."""
    s, r, t, bs = config["s"], config["r"], config["t"], config["block_size"]
    if s % bs or r % bs:
        raise ValueError(f"s={s}, r={r} do not divide by block_size {bs}")
    for key, size in (("nnz_a", s * r), ("nnz_b", s * t)):
        if not 0 < config[key] <= size:
            raise ValueError(f"{key}={config[key]} outside (0, {size}]")
    if config["dtype"] != "float32":
        raise ValueError(f"dtype {config['dtype']!r}: the harness draws float32 operands")
    return s, r, t, bs


def places(gen: torch.Generator, size: int, count: int, device) -> torch.Tensor:
    """``count`` distinct flat indices below ``size``, uniform without
    replacement: draws with replacement, their distinct values (a uniform
    subset of its size), and a uniform choice of ``count`` of those."""
    extra = count // 8 + 64
    while True:
        got = torch.unique(torch.randint(size, (count + extra,), generator=gen,
                                         device=device, dtype=torch.int64))
        if got.numel() >= count:
            pick = torch.randperm(got.numel(), generator=gen, device=device)[:count]
            return got[pick]
        extra *= 2


def sparse(gen, rows: int, cols: int, count: int, device) -> torch.Tensor:
    """A dense (rows, cols) f32 matrix with ``count`` standard normal
    nonzeros at uniform places."""
    at = places(gen, rows * cols, count, device)
    out = torch.zeros(rows * cols, device=device)
    out[at] = torch.randn(count, generator=gen, device=device)
    return out.view(rows, cols)


def draw(config: dict, seed: int, device) -> Operands:
    """A and B of ``config`` from ``seed`` on ``device``."""
    s, r, t, bs = geometry(config)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    A = sparse(gen, s, r, config["nnz_a"], device)
    B = sparse(gen, s, t, config["nnz_b"], device)
    RB, CB = s // bs, r // bs
    tiles = A.view(RB, bs, CB, bs)
    live = tiles.ne(0).any(dim=3).any(dim=1).T                 # (CB, RB)
    nnzb = live.sum(dim=1)
    L = max(int(nnzb.max()), 1)
    # each column block's live row blocks first, in ascending order
    key = torch.where(live, torch.arange(RB, device=device), RB)
    rows = key.sort(dim=1).values[:, :L]
    rows = torch.where(rows < RB, rows, 0)
    vals = tiles[rows, :, torch.arange(CB, device=device)[:, None], :]
    vals = vals * (torch.arange(L, device=device) < nnzb[:, None])[..., None, None]
    return Operands(A=A, B=B, vals=vals, rows=rows, nnzb=nnzb)


def block_ell(ops: Operands, config: dict):
    """A as the port's host ``BlockELL``."""
    from repro_torch.sparse.blocksparse import BlockELL

    s, r, _, bs = geometry(config)
    return BlockELL(vals=ops.vals.cpu().numpy(), idx=ops.rows.cpu().numpy().astype(np.int32),
                    nnzb=ops.nnzb.cpu().numpy().astype(np.int32), shape=(s, r), block_size=bs)

