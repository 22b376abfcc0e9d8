"""AdamW, a cosine schedule with warm-up, and clipping by the global norm,
on the port's nested dicts of tensors.

The arithmetic is the JAX package's: ``count`` is int32 and is incremented
before the learning rate and the bias corrections read it; the corrections
are f32; each leaf's moments update in f32 and are cast back to their
dtype (``state_dtype=torch.bfloat16`` keeps m and v in bf16, rounded to
nearest-even on every step, as ``astype`` rounds).  ``update`` is the
reference's functional form; ``update_`` does the same arithmetic in
place, a piece of at most ``PIECE`` elements at a time, which is how the
train step keeps its peak memory near four times the parameters (the
reference donates its buffers instead): a piece's temporaries, not a
stacked leaf's (internlm2-1.8b's ``w_gate`` is 403 M floats).

Under a ``DeviceMesh`` the parameters, gradients, m and v are DTensors in
the same placements (``train_step``): ``update_`` runs on each rank's own
shards, elementwise, with no collective, and ``global_norm`` sums each
shard once over the mesh.  ``count`` is a plain tensor on every rank,
replicated, as in the reference's optimizer-state shardings.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.training.tree import tree_leaves, tree_map, tree_unflatten


#: elements of a leaf that ``AdamW.update_`` updates at a time
PIECE = 1 << 24


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's own shard (a view this rank updates in place), else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _pieces(t: torch.Tensor):
    """Views of ``t`` along dim 0 of at most about ``PIECE`` elements."""
    if t.dim() == 0 or t.numel() <= PIECE:
        return (t,)
    return t.split(max(1, PIECE * t.shape[0] // t.numel()))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    state_dtype: torch.dtype | None = None  # None -> each parameter's dtype

    def init(self, params: dict) -> dict:
        def zeros(p):
            return torch.zeros_like(p, dtype=self.state_dtype or p.dtype)

        device = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def _scalars(self, count: torch.Tensor):
        c = count.float()
        lr = (self.lr(count) if callable(self.lr)
              else torch.tensor(self.lr, dtype=torch.float32, device=count.device))
        return 1.0 - self.b1 ** c, 1.0 - self.b2 ** c, lr

    def _leaf(self, g, m, v, p, bc1, bc2, lr):
        """One leaf's (update, m, v)."""
        gf = g.float()
        m_new = self.b1 * m.float() + (1 - self.b1) * gf
        v_new = self.b2 * v.float() + (1 - self.b2) * gf.square()
        step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
        step = step + self.weight_decay * p.float()
        return (-lr * step).to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    def update(self, grads: dict, state: dict, params: dict):
        """(updates, new_state); nothing given is written."""
        count = state["count"] + 1
        scalars = self._scalars(count)
        outs = [self._leaf(*leaves, *scalars) for leaves in zip(
            tree_leaves(grads), tree_leaves(state["m"]), tree_leaves(state["v"]),
            tree_leaves(params))]
        return tree_unflatten(params, [o[0] for o in outs]), {
            "m": tree_unflatten(params, [o[1] for o in outs]),
            "v": tree_unflatten(params, [o[2] for o in outs]),
            "count": count}

    @torch.no_grad()
    def update_(self, grads, state: dict, params: dict) -> None:
        """``update`` then ``apply_updates``, in place: each parameter
        becomes p + u and the state its new m, v and count, the same
        elementwise arithmetic a piece at a time.  ``grads``: a tree like
        ``params``, or its leaves in order."""
        state["count"].add_(1)
        scalars = self._scalars(state["count"])
        for leaves in zip(tree_leaves(grads) if isinstance(grads, dict) else grads,
                          tree_leaves(state["m"]), tree_leaves(state["v"]),
                          tree_leaves(params), strict=True):
            local = [_local(t) for t in leaves]
            for g, m, v, p in zip(*map(_pieces, local), strict=True):
                u, m_new, v_new = self._leaf(g, m, v, p, *scalars)
                p.add_(u)
                m.copy_(m_new)
                v.copy_(v_new)


def apply_updates(params: dict, updates: dict) -> dict:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares; ``tree``: a
    nested dict or a list of leaves.  Over DTensor leaves the sum is a
    partial one a rank (each shard counted on the one rank of its replicas
    at coordinate 0 of every dim it is replicated over), then one
    all-reduce over the mesh's group: a plain tensor, the same on every
    rank."""
    from torch.distributed.tensor import DTensor

    leaves = tree_leaves(tree) if isinstance(tree, dict) else tree
    meshes = {x.device_mesh for x in leaves if isinstance(x, DTensor)}
    if not meshes:
        return torch.sqrt(torch.stack([x.float().square().sum() for x in leaves]).sum())
    import torch.distributed as dist

    (mesh,) = meshes

    def part(x):
        own = x.to_local().float().square().sum()
        first = all(mesh.get_local_rank(i) == 0
                    for i, q in enumerate(x.placements) if q.is_replicate())
        return own if first else torch.zeros_like(own)

    total = torch.stack([part(x) for x in leaves]).sum()
    dist.all_reduce(total)
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(tree: dict, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, its norm
    before)."""
    gn = global_norm(tree)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), gn


@torch.no_grad()
def clip_by_global_norm_(leaves: list, max_norm: float) -> torch.Tensor:
    """``clip_by_global_norm`` in place over a list of leaves; returns the
    norm before."""
    gn = global_norm(leaves)
    scale = _clip_scale(gn, max_norm)
    for x in leaves:
        _local(x).mul_(scale.to(x.dtype))
    return gn


def cosine_warmup_schedule(peak_lr: float, warmup: int, total: int,
                           floor: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    """count -> lr (f32): linear from 0 to ``peak_lr`` over ``warmup``
    steps, then a cosine down to ``floor * peak_lr`` at ``total``."""
    def lr(count: torch.Tensor) -> torch.Tensor:
        c = count.float()
        warm = peak_lr * c / max(warmup, 1)
        frac = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(c < warmup, warm, cos)
    return lr
