"""The train step: loss -> grads -> clip -> AdamW -> apply.

``make_train_step(model, optimizer)`` gives ``step(params, opt_state,
batch) -> (params, opt_state, metrics)``, the JAX package's signature.
The reference jits its step and donates the parameters and the state;
here the step updates both in place under ``torch.no_grad()`` (the
gradients clipped in place too), so the peak stays near four times the
parameters, and returns the same dicts.  The arithmetic is the
reference's: each parameter becomes p + u.
"""

from __future__ import annotations

import torch

from repro_torch.training.optimizer import AdamW, clip_by_global_norm_
from repro_torch.training.tree import tree_leaves, tree_unflatten


def value_and_grad(model, params: dict, batch: dict):
    """(loss, grads) of ``model.loss`` at ``params`` (the reference's
    ``jax.value_and_grad``): grads is a tree like ``params``, zeros where a
    parameter does not reach the loss.  ``params`` is left as it is."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss = model.loss(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


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
