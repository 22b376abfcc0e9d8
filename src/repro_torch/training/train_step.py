"""The train step: loss -> grads -> clip -> AdamW -> apply.

``make_train_step(model, optimizer)`` gives ``step(params, opt_state,
batch) -> (params, opt_state, metrics)``, the JAX package's signature.
The reference jits its step and donates the parameters and the state;
here the step updates both in place under ``torch.no_grad()`` (the
gradients clipped in place too), so the peak stays near four times the
parameters, and returns the same dicts.  The arithmetic is the
reference's: each parameter becomes p + u.

Under a ``DeviceMesh`` (``launch.meshctx``) the parameters and the
optimizer state are DTensors placed by ``Model.specs()``
(``meshctx.distribute``), the reference's ``in_shardings``; the gradients
come back in the parameters' placements, and the update runs on each
rank's own shards.
"""

from __future__ import annotations

import torch

from repro_torch.launch import meshctx
from repro_torch.training.optimizer import AdamW, clip_by_global_norm_
from repro_torch.training.tree import tree_leaves, tree_unflatten


def value_and_grad(model, params: dict, batch: dict):
    """(loss, grads) of ``model.loss`` at ``params`` (the reference's
    ``jax.value_and_grad``): grads is a tree like ``params``, zeros where a
    parameter does not reach the loss.  ``params`` is left as it is.  A
    DTensor parameter's gradient is placed as the parameter is (a sum
    over the ranks that share it is reduced); the loss is then replicated."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad(), meshctx.replicate_plain():
        loss = model.loss(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else _placed_like(g, p)
                 for p, g in zip(leaves, grads)]
        loss = _placed_like(loss.detach(), None)
    return loss, tree_unflatten(params, grads)


def _placed_like(t, like):
    """``t`` in ``like``'s placements (all replicated for ``like=None``)
    where it is a DTensor; else ``t``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    want = (like.placements if like is not None
            else [Replicate()] * t.device_mesh.ndim)
    return t if tuple(t.placements) == tuple(want) else t.redistribute(t.device_mesh, want)


def make_train_step(model, optimizer: AdamW, clip_norm: float = 1.0):
    def train_step(params: dict, opt_state: dict, batch: dict):
        loss, grads = value_and_grad(model, params, batch)
        grads = tree_leaves(grads)
        gnorm = clip_by_global_norm_(grads, clip_norm)
        optimizer.update_(grads, opt_state, params)
        return params, opt_state, {"loss": loss.float(), "grad_norm": gnorm.float()}

    return train_step


def make_eval_step(model):
    def eval_step(params: dict, batch: dict) -> torch.Tensor:
        with torch.no_grad():
            return model.loss(params, batch).float()
    return eval_step
