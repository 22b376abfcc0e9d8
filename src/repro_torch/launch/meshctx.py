"""The active mesh, as the model code and the dry run read it.

The active mesh is either a plain ordered dict of axis sizes, ``{"data":
16, "model": 16}`` (``launch.mesh``: the dry run prices placements on it,
and nothing is sharded), or a ``torch.distributed`` ``DeviceMesh`` whose
dim names are the axes (``launch.mesh.device_mesh``: the sharded train
step).  ``use_mesh`` makes one active for a block; ``spec`` turns a
placement's axis names into the one the active mesh can hold, and
``placements`` turns that into one DTensor placement per mesh dim.

Model code calls ``maybe_shard(x, "dp", None, "model")`` where the JAX
package attaches a GSPMD sharding constraint.  With a ``DeviceMesh``
active it redistributes a DTensor to that placement; with no mesh, a
dict mesh, or a plain tensor it is ``x`` itself, so the same model code
runs everywhere and the one-process path is unchanged.

The mesh lives in a ContextVar, which autograd's device thread does not
see: a pass that may run there (the remat recompute) runs in a copy of
the forward's context (``models.registry``).
"""

from __future__ import annotations

import contextlib
import contextvars

_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


def get_mesh():
    """The active mesh: a dict of axis sizes, a ``DeviceMesh``, or None."""
    return _MESH.get()


def set_mesh(mesh) -> None:
    _MESH.set(mesh)


@contextlib.contextmanager
def use_mesh(mesh):
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def mesh_shape(mesh) -> dict:
    """{axis: size} of a dict mesh or a ``DeviceMesh``, in the mesh's order."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape, strict=True))


def device_mesh():
    """The active mesh if it is a ``DeviceMesh``, else None."""
    mesh = get_mesh()
    return None if mesh is None or isinstance(mesh, dict) else mesh


def axis_size(name: str) -> int:
    """The size of axis ``name`` on the active mesh (1 where it has none)."""
    return mesh_shape(get_mesh()).get(name, 1)


def dp_size() -> int:
    """The data-parallel degree: the product of "pod" and "data"."""
    return axis_size("pod") * axis_size("data")


def spec(*axes) -> tuple:
    """A placement tuple, dropping the axes the active mesh does not have.

    ``"dp"`` is an alias for the whole data-parallel product: ("pod",
    "data") on a multi-pod mesh, "data" on a single-pod mesh, dropped with
    no mesh.  With no mesh active the placement is ``()``, replicated."""
    mesh = get_mesh()
    if mesh is None:
        return ()
    names = set(mesh_shape(mesh))
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


def placements(axes: tuple, mesh) -> list:
    """One DTensor placement per dim of ``mesh`` for the placement tuple
    ``axes`` (as ``spec`` gives it): a mesh dim named on tensor dim i, alone
    or in a tuple such as ("pod", "data"), is ``Shard(i)``; every other is
    ``Replicate()``.  A tuple's axes split the tensor dim in mesh order,
    major first, as a ``PartitionSpec``'s do."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for i, a in enumerate(axes):
        for name in (a if isinstance(a, tuple) else (a,)):
            if name is None:
                continue
            if name in where:
                raise ValueError(f"mesh axis {name!r} shards two dims of {axes}")
            where[name] = i
    return [Shard(where[n]) if n in where else Replicate() for n in mesh.mesh_dim_names]


def maybe_shard(x, *axes):
    """``x`` redistributed to ``spec(*axes)`` when a ``DeviceMesh`` is active
    and ``x`` is a DTensor; else ``x`` itself."""
    from torch.distributed.tensor import DTensor

    mesh = device_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    want = placements(spec(*axes), mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh, want)


def local(fn, in_axes: tuple, out_axes: tuple, grad_partial: dict | None = None):
    """``fn`` run on each rank's own shards under the active ``DeviceMesh``
    (``local_map``): argument i redistributed to the placement tuple
    ``in_axes[i]`` (None: not a tensor), output j placed by
    ``out_axes[j]`` (one entry: ``fn`` returns one tensor); ``()`` is
    replicated.  ``grad_partial[i]``: the mesh axes over which argument
    i's gradient is a partial sum (each rank saw a part of its uses), where
    it is not placed as the argument is.  With no ``DeviceMesh``, ``fn``
    itself."""
    mesh = device_mesh()
    if mesh is None:
        return fn
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    def pl(axes):
        return None if axes is None else placements(spec(*axes), mesh)

    def grad_pl(i, axes):
        summed = (grad_partial or {}).get(i, ())
        if axes is None or not summed:
            return pl(axes)
        return [Partial() if n in summed else q
                for n, q in zip(mesh.mesh_dim_names, pl(axes), strict=True)]

    outs = tuple(pl(a) for a in out_axes)
    mapped = local_map(fn, out_placements=outs if len(outs) > 1 else outs[0],
                       in_placements=tuple(pl(a) for a in in_axes),
                       in_grad_placements=tuple(grad_pl(i, a) for i, a in enumerate(in_axes)),
                       device_mesh=mesh)

    def run(*args):
        return mapped(*(a if ax is None else maybe_shard(a, *ax)
                        for a, ax in zip(args, in_axes, strict=True)))
    return run


def distribute(tree, specs, mesh):
    """The counterpart of ``NamedSharding(mesh, spec(*s))`` on a tree: each
    tensor of ``tree`` (nested dicts) as a DTensor placed by its tuple in
    ``specs``, read under ``mesh``.  Every rank passes the same full
    values; each keeps its shard."""
    from torch.distributed.tensor import distribute_tensor

    with use_mesh(mesh):
        def walk(t, s):
            if isinstance(t, dict):
                return {k: walk(t[k], s[k]) for k in t}
            return distribute_tensor(t, mesh, placements(spec(*s), mesh))
        return walk(tree, specs)


_REPLICATING = [False]  # an outer ``replicate_plain`` block holds the process's flag


@contextlib.contextmanager
def replicate_plain():
    """Where a ``DeviceMesh`` is active, a block in which a plain tensor
    meeting a DTensor counts as replicated (``implicit_replication``): the
    positions, masks and constants the model makes on each rank are the
    same everywhere.  Blocks nest: the outermost sets the flag and clears
    it (``implicit_replication`` alone clears it on leaving an inner
    block).  Else a block that does nothing."""
    if device_mesh() is None or _REPLICATING[0]:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _REPLICATING[0] = True
    try:
        with implicit_replication():
            yield
    finally:
        _REPLICATING[0] = False
