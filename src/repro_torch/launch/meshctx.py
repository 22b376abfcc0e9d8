"""The active mesh, as the model code and the dry run read it.

The active mesh is either a plain ordered dict of axis sizes, ``{"data":
16, "model": 16}`` (``launch.mesh``: the dry run prices placements on it,
and nothing is sharded), or a ``torch.distributed`` ``DeviceMesh`` whose
dim names are the axes (``launch.mesh.device_mesh``: the sharded train
step).  ``use_mesh`` makes one active for a block; ``spec`` turns a
placement's axis names into the one the active mesh can hold, and
``placements`` turns that into one DTensor placement per mesh dim.

Model code calls ``maybe_shard(x, "dp", None, "model")`` where the JAX
package attaches a GSPMD sharding constraint; ``fitted`` replicates the
dims that a placement's axes do not divide (the dry run's sanitizer), and
``zeros`` makes a tensor of zeros placed so, each rank allocating only its
own shard (a cache).  ``Collectives`` records the collectives a sharded
program issues, the counterpart of the JAX package's
``collective_bytes`` of the compiled HLO.  With a ``DeviceMesh``
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
import math

import torch

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


def dp_axes() -> tuple:
    """The active mesh's data-parallel axes: those of ("pod", "data") it has."""
    names = mesh_shape(get_mesh())
    return tuple(a for a in ("pod", "data") if a in names)


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


def fitted(shape: tuple, axes: tuple) -> tuple:
    """The placement tuple ``axes`` (one entry a dim, as ``spec`` gives it)
    with every dim that its axes do not divide on the active mesh
    replicated instead -- the production choice for odd head counts, vocab
    sizes and short memory axes."""
    sizes = mesh_shape(get_mesh())
    out = []
    for dim, a in zip(shape, tuple(axes) + (None,) * (len(shape) - len(axes))):
        n = math.prod(sizes[x] for x in (a if isinstance(a, tuple) else (a,))
                      if x is not None)
        out.append(a if a is not None and dim % n == 0 else None)
    return tuple(out)


def fit(size: int, axis):
    """``axis`` (resolved by ``spec``) where ``size`` divides among its
    shards on the active mesh, else None (replicated)."""
    resolved = spec(axis)
    return fitted((size,), resolved)[0] if resolved else None


def zeros(shape: tuple, dtype, device, axes: tuple):
    """A tensor of zeros of ``shape`` placed by ``fitted(shape, axes)``
    under the active ``DeviceMesh`` (a DTensor each rank allocates only
    its own shard of); with no ``DeviceMesh`` a plain tensor."""
    mesh = device_mesh()
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor

    axes = fitted(shape, axes)
    sizes = mesh_shape(mesh)
    local_shape = tuple(
        d // math.prod(sizes[x] for x in (a if isinstance(a, tuple) else (a,)))
        if a is not None else d for d, a in zip(shape, axes))
    local_t = torch.zeros(local_shape, dtype=dtype, device=device)
    full = torch.empty(shape, dtype=dtype, device="meta")
    return DTensor.from_local(local_t, mesh, placements(axes, mesh), run_check=False,
                              shape=full.shape, stride=full.stride())


def maybe_shard(x, *axes):
    """``x`` redistributed to ``spec(*axes)`` when a ``DeviceMesh`` is active
    and ``x`` is a DTensor; else ``x`` itself.  A dim placed over "dp" that
    the dp shards do not divide (a batch of 3 on 2 shards) is replicated
    over them, as ``fit`` places it: the reference's GSPMD pads it
    instead, to the same values."""
    from torch.distributed.tensor import DTensor

    mesh = device_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    axes = tuple(fit(x.shape[i], a) if a == "dp" else a for i, a in enumerate(axes))
    want = placements(spec(*axes), mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(mesh, want)


def grad_placed(x, *axes):
    """``x`` itself, its gradient redistributed to ``spec(*axes)`` in the
    backward pass (a DTensor under a ``DeviceMesh``; else ``x``): for a
    view whose backward DTensor cannot run on the placement the gradient
    arrives in (the split of an unevenly sharded dim)."""
    from torch.distributed.tensor import DTensor

    mesh = device_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    return _GradPlaced.apply(x, tuple(placements(spec(*axes), mesh)))


class _GradPlaced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def local(fn, in_axes: tuple, out_axes: tuple, grad_partial: dict | None = None):
    """``fn`` run on each rank's own shards under the active ``DeviceMesh``
    (``local_map``): argument i redistributed to the placement tuple
    ``in_axes[i]`` (None: not a tensor), output j placed by
    ``out_axes[j]`` (one entry: ``fn`` returns one tensor); ``()`` is
    replicated.  ``grad_partial[i]``: the mesh axes over which argument
    i's gradient is a partial sum (each rank saw a part of its uses), where
    it is not placed as the argument is.  With no ``DeviceMesh``, ``fn``
    itself.

    Every dim that a placement shards must divide among its shards, or
    this raises ``ValueError`` naming it: ``local_map`` gives an output the
    global shape of an even split, which DTensor's split of an odd dim is
    not (``fitted`` gives the placement that replicates such dims).  The
    outputs' shards are taken to be even where the inputs' are."""
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
        for i, (a, ax) in enumerate(zip(args, in_axes, strict=True)):
            want = None if ax is None else spec(*ax) + (None,) * (a.dim() - len(spec(*ax)))
            if want is not None and fitted(a.shape, want) != want:
                raise ValueError(f"meshctx.local: argument {i} {tuple(a.shape)} placed "
                                 f"{want}: a sharded dim does not divide among its "
                                 f"shards on {mesh_shape(mesh)}")
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


# ------------------------------ collectives ----------------------------------

#: the collective kinds, as the JAX package names them in its HLO record
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# op (namespace, name) -> kind.  The functional collectives are what DTensor
# issues (inside an op or in ``redistribute``); the c10d ones are the
# in-place collectives of ``torch.distributed`` (the global norm's
# all-reduce).  ``wait_tensor`` and ``_wrap_tensor_autograd`` move nothing.
_KINDS = {
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_c10d_functional_autograd", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
    ("_c10d_functional", "broadcast"): "broadcast",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allreduce_coalesced_"): "all-reduce",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "allgather_into_tensor_coalesced_"): "all-gather",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "reduce_scatter_tensor_coalesced_"): "reduce-scatter",
    ("c10d", "alltoall_"): "all-to-all",
    ("c10d", "alltoall_base_"): "all-to-all",
    ("c10d", "send"): "collective-permute",
    ("c10d", "recv_"): "collective-permute",
    ("c10d", "broadcast_"): "broadcast",
}


def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def shape_only(*trees) -> bool:
    """Whether an operation's arguments or outputs are fake tensors:
    DTensor runs each new op signature once on fake tensors of the global
    shapes to learn its output's shape, which is no work of this rank's
    (and allocates nothing)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._pytree import tree_leaves

    return any(isinstance(t, FakeTensor) for t in tree_leaves(trees))


def _group_of(args) -> str | None:
    """The name of the process group a collective's arguments name: a
    functional collective's by name (a str), a c10d one's as a script
    object."""
    import torch.distributed as dist

    for a in args:
        if isinstance(a, str) and a and a not in ("sum", "avg", "max", "min", "product"):
            return a
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).group_name
            except RuntimeError:
                continue
    return None


class Collectives:
    """The collectives issued while it is entered, rank by rank as this
    process sees them: ``records`` a list of (kind, mesh dim, bytes), each
    the bytes of the collective's output (an all-gather's gathered tensor, a
    reduce-scatter's shard, an all-reduce's tensor), as the JAX package
    counts an HLO instruction's.

    A dispatch mode that hands DTensor's own ops back to DTensor
    (``NotImplemented``), so that it sees the collectives DTensor issues
    inside an op (a matmul's implicit all-gather) as well as an explicit
    ``redistribute``'s, and the backward's: the mode is in the thread's
    dispatch state, which autograd carries to its device threads.  The mesh
    dim is named from the active ``DeviceMesh``'s groups at entry ("world"
    for the default group, the group's name otherwise).

    ``summary()`` is the JAX package's dict: ``{"bytes": {kind: n},
    "counts": {kind: n}, "total_bytes": n}`` over ``COLLECTIVES`` (a kind
    outside them, a broadcast, is added where it occurs)."""

    def __init__(self):
        self.records: list[tuple[str, str, int]] = []
        self._mode = None

    def __enter__(self):
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        names = {}
        mesh = device_mesh()
        if dist.is_initialized():
            names[dist.group.WORLD.group_name] = "world"
        if mesh is not None:
            for dim in mesh.mesh_dim_names:
                names[mesh.get_group(dim).group_name] = dim
        records = self.records

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                key = (func.namespace, func.__name__.split(".")[0])
                kind = _KINDS.get(key)
                if kind is not None and not shape_only(args, out):
                    moved = out if func.namespace != "c10d" else args[0]
                    group = _group_of(list(args) + list(kwargs.values()))
                    records.append((kind, names.get(group, group), _nbytes(moved)))
                return out

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None

    def summary(self) -> dict:
        out = dict.fromkeys(COLLECTIVES, 0)
        counts = dict.fromkeys(COLLECTIVES, 0)
        for kind, _, n in self.records:
            out[kind] = out.get(kind, 0) + n
            counts[kind] = counts.get(kind, 0) + 1
        return {"bytes": out, "counts": counts, "total_bytes": int(sum(out.values()))}
