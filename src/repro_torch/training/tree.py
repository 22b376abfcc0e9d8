"""Nested dicts of tensors, flattened in ``jax.tree.flatten``'s leaf order.

The port's parameters and optimizer state are nested dicts (the JAX
package's own tree).  JAX flattens a dict in sorted-key order, and both
checkpoint formats depend on that order: the npz members ``arr_i`` and the
coded manifest's ``leaf_shapes``.  So every walk over a tree here goes
through ``tree_leaves``, which sorts the keys at every level.
"""

from __future__ import annotations

from typing import Callable


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(template, leaves) -> dict:
    """A tree of ``template``'s structure holding ``leaves`` in
    ``tree_leaves`` order.  Raises if the counts differ."""
    leaves = list(leaves)
    want = len(tree_leaves(template))
    if len(leaves) != want:
        raise ValueError(f"{len(leaves)} leaves for a tree of {want}")
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(template)


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of ``tree`` and of the trees in ``rest``, which
    share its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)
