"""The active mesh, as the model code and the dry run read it.

A mesh here is a plain ordered dict of axis sizes, ``{"data": 16,
"model": 16}`` (``launch.mesh``): the dry run prices placements on it, and
nothing is sharded.  ``use_mesh`` makes one active for a block; ``spec``
turns a placement's axis names into the one the active mesh can hold.
With no mesh active every placement is replicated.  The JAX package's
``maybe_shard`` has no counterpart: the port's model code attaches no
sharding constraints (ROADMAP queue 1, item 8b).
"""

from __future__ import annotations

import contextlib
import contextvars

_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


def get_mesh() -> dict | None:
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh: dict):
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def spec(*axes) -> tuple:
    """A placement tuple, dropping the axes the active mesh does not have.

    ``"dp"`` is an alias for the whole data-parallel product: ("pod",
    "data") on a multi-pod mesh, "data" on a single-pod mesh, dropped with
    no mesh.  With no mesh active the placement is ``()``, replicated."""
    mesh = get_mesh()
    if mesh is None:
        return ()
    names = set(mesh)
    out = []
    for a in axes:
        if a == "dp":
            dp = tuple(x for x in ("pod", "data") if x in names)
            out.append(dp if len(dp) > 1 else (dp[0] if dp else None))
        elif a is None:
            out.append(None)
        elif isinstance(a, tuple):
            kept = tuple(x for x in a if x in names)
            out.append(kept if kept else None)
        else:
            out.append(a if a in names else None)
    return tuple(out)
