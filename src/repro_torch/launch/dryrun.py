"""Dry run: every (arch x shape x mesh) cell, sharded, on a fake mesh.

    python -m repro_torch.launch.dryrun [--arch A] [--shape S] [--mesh single|multi|both]

For each cell the step function the JAX package compiles -- the train step
(bf16 parameters, AdamW with f32 state), the prefill step, or one decode
token against a bf16 cache -- is built on meta tensors (shapes and dtypes,
no storage), each argument leaf placed by its sanitised placement on the
mesh, and run once, sharded, in this process: rank 0 of a fake process
group of the mesh's size (``launch.mesh.fake_device_mesh``; 256 or 512
ranks, collectives that move nothing), so no card and no other process.
The record keeps the JAX package's keys where their meaning carries over:

* ``memory_analysis.argument_bytes`` is exact arithmetic: each argument
  leaf's per-device shard under its sanitised placement, summed
  (parameters, optimizer state, batch and cache);
* ``temp_bytes`` is the most bytes rank 0's own allocations hold at once,
  tracked over the local storages it allocates (``LiveBytes``; a
  DTensor's shard and the collectives' output buffers alike), and
  ``peak_bytes_est`` the arguments plus that.  It leaves out what is no
  tensor the step makes: the process group's own buffers and a library's
  workspaces;
* ``cost_analysis.flops_per_device`` is rank 0's own products: the
  ``torch.utils.flop_counter`` formulas over the operations on its local
  shards (``LocalFlops``; matrix products and attention, elementwise work
  not counted).  Work that every shard of an axis repeats (replicated
  heads, the flash-decode combine's all heads) counts on each, so it can
  exceed the global FLOPs over the device count;
* ``collectives`` is the JAX package's dict, ``{"bytes": {kind: n},
  "counts": {kind: n}, "total_bytes": n}``: every collective rank 0
  issues, forward and backward, each the bytes of its output
  (``meshctx.Collectives``);
* what needs XLA is ``None``: ``bytes_per_device`` (XLA's bytes accessed)
  and ``transcendentals`` (no counter of the port counts them);
* ``meta_s`` (the JAX package's ``compile_s``) is the sharded meta run's
  seconds.

A ``dict`` mesh given to ``run_cell`` is a fake mesh of that shape; its
device type is the card's ("cuda": DTensor moves a shard to another dim
by one all-to-all, as over NCCL), or ``device="cpu"`` for gloo's
all-gather-and-chunk.

Configs whose mixers scan over time (rwkv, mamba) run one Python step a
token a layer.  For them ``run_cell`` runs the 1- and 2-group probes and
extrapolates flops, bytes and each kind of collective with ``_combine``,
as the roofline's ``analyze_cell`` does (``depth`` says which was run):
exact for flops and collectives, since every group is structurally
identical, and a linear estimate of the peak.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCHS, get
from repro_torch.launch import meshctx
from repro_torch.launch.mesh import fake_device_mesh, make_production_mesh
from repro_torch.models.registry import build
from repro_torch.serving.serve_step import make_prefill_step
from repro_torch.training.data import input_specs
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_step import make_train_step

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32_768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32_768, batch=128, kind="decode"),
    "long_500k": dict(seq=524_288, batch=1, kind="decode"),
}

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "torch" / "dryrun"


def cell_supported(cfg, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention (skip per spec)"
    return True, ""


# ------------------------------ trees ----------------------------------------
# Argument trees are nested dicts and lists (a mamba cache slot) of meta
# tensors, with the cache's ``pos`` a host int; placement trees have the same
# structure with a tuple at each leaf.

def _map(fn, tree, *rest, path=()):
    """fn(path, leaf, *leaves of rest) over dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest), path=path + (k,))
                for k in tree}
    if isinstance(tree, list):
        return [_map(fn, t, *(r[i] for r in rest), path=path + (i,))
                for i, t in enumerate(tree)]
    return fn(path, tree, *rest)


def _leaves(tree) -> list:
    out = []
    _map(lambda _, leaf: out.append(leaf), tree)
    return out


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def _itemsize(leaf) -> int:
    # a host int leaf (the cache's pos) counts as the JAX package's int32
    return leaf.element_size() if isinstance(leaf, torch.Tensor) else 4


# ---------------------------- placements -------------------------------------

def _axis_size(axes, mesh: dict) -> int:
    names = axes if isinstance(axes, tuple) else (axes,)
    return math.prod(mesh[n] for n in names)


def shard_shape(shape: tuple, spec: tuple, mesh: dict) -> tuple:
    """One device's block of a ``shape`` placed by ``spec`` on ``mesh``
    (``spec`` sanitised: each sharded dimension divides)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, axes in zip(shape, spec):
        if axes is None:
            out.append(dim)
            continue
        n = _axis_size(axes, mesh)
        if dim % n:
            raise ValueError(f"dimension {dim} does not divide over {axes} ({n})")
        out.append(dim // n)
    return tuple(out)


def shard_bytes(leaf, spec: tuple, mesh: dict) -> int:
    return math.prod(shard_shape(_shape(leaf), spec, mesh)) * _itemsize(leaf)


def argument_bytes(args, specs, mesh: dict) -> int:
    """Per-device bytes of every argument leaf under its placement."""
    return sum(_leaves(_map(lambda _, a, s: shard_bytes(a, s, mesh), args, specs)))


def _resolve(specs):
    """Each ``ParamDef`` placement resolved on the active mesh."""
    return _map(lambda _, s: meshctx.spec(*s), specs)


def _batch_specs(batch: dict) -> dict:
    return {k: meshctx.spec("dp", None) if v.dim() == 2 else meshctx.spec("dp", None, None)
            for k, v in batch.items()}


def PSpecDrop(spec: tuple, axis: str) -> tuple:
    out = []
    for entry in spec:
        if entry == axis:
            out.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a != axis)
            out.append(kept if kept else None)
        else:
            out.append(entry)
    return tuple(out)


def _serving_layout(param_specs: dict) -> dict:
    """Decode-time weight layout (``opt_serving_layout``), on the active mesh.

    At one token a step there is no batch to amortise sharding the weights
    over "data", so "data" shards a contraction (or output) dimension
    instead: each matmul emits a partial that one sum fixes and no weight
    moves.  KV caches keep the "model" axis.  ``param_specs`` are
    sanitised placements (one entry a dimension)."""
    ns = meshctx.spec

    def rewrite(path, sh):
        leaf = path[-1] if path else None
        if leaf in ("w_gate", "w_up"):
            if len(sh) == 4:      # MoE experts (G, E, d, ff)
                return ns(None, "model", None, "data")
            return ns(None, None, "data")          # dense MLP (G, d, ff)
        if leaf == "w_down":
            if len(sh) == 4:      # (G, E, ff, d)
                return ns(None, "model", "data", None)
            return ns(None, "data", None)          # (G, ff, d)
        if leaf in ("wq", "wk", "wv", "wr", "wg"):
            return ns(None, None, "data")          # out-dim over data
        if leaf == "wo":
            return ns(None, "data", None)          # in-dim over data -> sum
        if leaf in ("embed", "head"):
            return sh                               # vocab stays model-sharded
        # mamba's projections keep d_inner on 'model'; everything else
        # drops 'data' (small tensors replicated)
        return PSpecDrop(sh, "data")

    return _map(rewrite, param_specs)


def _sanitize(structs, specs, mesh: dict):
    """Replicate any dimension whose size its axes do not divide -- the
    production choice for odd head counts, vocab sizes and short memory
    axes (``meshctx.fitted``).  The result has one entry a dimension."""
    with meshctx.use_mesh(mesh):
        return _map(lambda _, struct, spec: meshctx.fitted(_shape(struct), spec),
                    structs, specs)


# ---------------------------- cell builders ----------------------------------

def build_cell(cfg, shape_name: str, mesh: dict, ce_chunk=None, device="meta"):
    """(step, args, arg_specs, kinds): the cell's step function, its
    arguments as meta tensors, each argument leaf's sanitised placement on
    ``mesh`` (run under ``meshctx.use_mesh(mesh)``), and what each argument
    is (params, opt_state, batch, cache).  The step's model is built on
    ``device``: meta for the dry run, or the card (None) or the CPU to run
    the cell for real on arguments made there in the meta ones' shapes and
    dtypes.  (The JAX package's ``scan_unroll`` has no counterpart: the
    port's groups are a Python loop, always unrolled.)"""
    info = SHAPES[shape_name]
    meta = build(cfg, "meta")
    model = meta if device is not None and torch.device(device).type == "meta" \
        else build(cfg, device)
    model.ce_chunk = ce_chunk
    params = meta.shapes(torch.bfloat16)
    param_specs = _sanitize(params, _resolve(meta.specs()), mesh)
    batch = input_specs(cfg, info["batch"], info["seq"], kind=info["kind"])
    batch_specs = _sanitize(batch, _batch_specs(batch), mesh)

    if info["kind"] == "train":
        opt = AdamW(lr=1e-4, state_dtype=torch.float32)
        opt_state = opt.init(params)
        opt_specs = {"m": param_specs, "v": param_specs, "count": ()}
        return (make_train_step(model, opt), (params, opt_state, batch),
                (param_specs, opt_specs, batch_specs), ("params", "opt_state", "batch"))

    if info["kind"] == "prefill":
        prefill = make_prefill_step(model, max_seq=info["seq"])

        def prefill_fn(params, batch):
            with torch.no_grad():
                return prefill(params, batch)

        return (prefill_fn, (params, batch), (param_specs, batch_specs),
                ("params", "batch"))

    # decode: one token against a cache of length seq
    if getattr(cfg, "opt_serving_layout", False):
        param_specs = _sanitize(params, _serving_layout(param_specs), mesh)
    with meshctx.use_mesh(mesh):  # the cache's global shapes: placed by ``place``
        cache = meta.init_cache(info["batch"], info["seq"], torch.bfloat16)
    cache_specs = _sanitize(cache, meta.cache_specs(cache), mesh)
    tokens = batch["tokens"]
    tok_specs = _sanitize(tokens, meshctx.spec("dp", None), mesh)

    def decode_fn(params, cache, tokens):
        with torch.no_grad():
            logits, cache = model.decode_step(params, cache, tokens)
            return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache

    return (decode_fn, (params, cache, tokens), (param_specs, cache_specs, tok_specs),
            ("params", "cache", "batch"))


# ------------------------------ live bytes -----------------------------------

def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def _local(t):
    """A DTensor's own shard, else ``t``."""
    return t.to_local() if isinstance(t, _dtensor()) else t


class LocalFlops(TorchDispatchMode):
    """The FLOPs of the operations on this rank's own tensors, by
    ``torch.utils.flop_counter``'s formulas: a DTensor's operation is
    handed back to DTensor, so the count is of its local shards' products
    (``FlopCounterMode`` outside DTensor counts an operation's global
    shapes instead)."""

    def __init__(self):
        super().__init__()
        self._counter = FlopCounterMode(display=False)

    def total(self) -> int:
        return self._counter.get_total_flops()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, _dtensor()) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if meshctx.shape_only(args, out):
            return out
        return self._counter._count_flops(func._overloadpacket, out, args, kwargs)


def place(args, specs, dmesh, make=None):
    """The argument trees with each tensor leaf of a dim or more a DTensor
    on ``dmesh`` placed by its sanitised spec, from a local shard
    ``make(local_shape, leaf, path)`` (default: an empty meta tensor); a
    0-dim leaf (the optimizer's count) stays a plain tensor (made so too)
    and a host int (the cache's pos) as it is, as the train step keeps
    them."""
    from torch.distributed.tensor import DTensor

    mesh = meshctx.mesh_shape(dmesh)

    def leaf(path, a, s):
        if not isinstance(a, torch.Tensor):
            return a
        if a.dim() == 0:
            return a if make is None else make((), a, path)
        local_shape = shard_shape(tuple(a.shape), s, mesh)
        local_t = (torch.empty(local_shape, dtype=a.dtype, device="meta") if make is None
                   else make(local_shape, a, path))
        return DTensor.from_local(local_t, dmesh, meshctx.placements(s, dmesh),
                                  run_check=False, shape=a.shape, stride=a.stride())

    return [_map(leaf, tree, spec) for tree, spec in zip(args, specs)]


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages that the operations under it allocate,
    while they live: ``live`` now, ``peak`` the most at once.

    An operation's output allocates when its storage is none of its
    inputs' (a view or an in-place result shares one); a storage counts
    from its first output until it is freed.  Storages made before the
    mode (the arguments) never count.  A DTensor's operation is handed
    back to DTensor, so the mode sees the operations on the local shards
    that it runs (the collectives' outputs among them): this rank's
    storages, not the fake tensors of DTensor's shape propagation."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()   # storage -> (bytes, weakref)

    def _free(self, nbytes: int, _ref) -> None:
        self.live -= nbytes

    def owns(self, t: torch.Tensor) -> bool:
        return t.untyped_storage() in self._seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, _dtensor()) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if meshctx.shape_only(args, out):
            return out
        inputs = {id(t.untyped_storage()) for t in _pytree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in _pytree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if id(st) in inputs or st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = (n, weakref.ref(st, lambda ref, n=n: self._free(n, ref)))
            self.live += n
            self.peak = max(self.peak, self.live)
        return out


def _measure(cfg, shape_name: str, mesh: dict, ce_chunk=None, device="cuda") -> dict:
    """One sharded meta run of the cell's step at ``cfg``'s depth, as rank
    0 of a fake ``mesh`` (``device`` its type): its local FLOPs, the most
    bytes its allocations held at once (``temp``), what its outputs hold
    of them (``out``), which argument leaves they hand back (``alias``),
    and its collectives (``coll/bytes/<kind>``, ``coll/counts/<kind>``),
    all per device."""
    with meshctx.use_mesh(mesh):
        fn, args, specs, _ = build_cell(cfg, shape_name, mesh, ce_chunk=ce_chunk)
    with fake_device_mesh(mesh, device) as dmesh, meshctx.use_mesh(dmesh):
        args = place(args, specs, dmesh)
        per_device = {}  # an argument's local storage -> its bytes
        for t in _pytree_leaves(args):
            if isinstance(t, torch.Tensor):
                st = _local(t).untyped_storage()
                per_device[id(st)] = _local(t).numel() * _local(t).element_size()
        t0 = time.perf_counter()
        with LocalFlops() as flops, LiveBytes() as live, meshctx.Collectives() as coll:
            out = fn(*args)
        seconds = time.perf_counter() - t0
        outs = [_local(t) for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        held = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                for t in outs if live.owns(t)}
        alias = {id(t.untyped_storage()) for t in outs} & per_device.keys()
        summary = coll.summary()
    record = {"flops": float(flops.total()), "temp": float(live.peak),
              "out": float(sum(held.values())),
              "alias": float(sum(per_device[i] for i in alias)), "seconds": seconds}
    for what in ("bytes", "counts"):
        for kind, n in summary[what].items():
            record[f"coll/{what}/{kind}"] = float(n)
    return record


def _collectives(m: dict) -> dict:
    """The JAX package's collectives dict from a measure's ``coll/`` keys."""
    out = {"bytes": {}, "counts": {}}
    for k, v in m.items():
        if k.startswith("coll/"):
            _, what, kind = k.split("/", 2)
            out[what][kind] = int(round(v))
    out["total_bytes"] = int(sum(out["bytes"].values()))
    return out


def _probe_cfg(cfg, groups: int, enc_layers: int | None = None):
    g = cfg.group_size
    kw = {"num_layers": g * groups, "name": f"{cfg.name}-probe{groups}"}
    if cfg.encoder_layers:
        kw["encoder_layers"] = enc_layers if enc_layers is not None else 1
    return dataclasses.replace(cfg, **kw)


def _combine(p1: dict, p2: dict, reps: int) -> dict:
    """total = p1 + (reps-1) * (p2 - p1), clamped at >= p1, for every key
    of either probe (a kind of collective one probe lacks counts 0 there);
    a term that is None in the probes stays None."""
    out = {}
    for k in p1.keys() | p2.keys():
        a, b = p1.get(k, 0.0), p2.get(k, 0.0)
        if a is None:
            out[k] = None
            continue
        out[k] = a + (reps - 1) * max(b - a, 0.0)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool, cfg_override=None,
             ce_chunk=None, mesh=None, probes: bool | None = None,
             device="cuda") -> dict:
    """The cell's record (module docstring).  ``probes``: None runs the
    1- and 2-group probes for configs that scan over time and the full
    depth otherwise; True or False forces either.  ``mesh``: a dict of
    axis sizes (default the production mesh), run as a fake mesh of
    ``device``'s type."""
    cfg = cfg_override or get(arch)
    ok, why = cell_supported(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": "skipped", "reason": why}
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    record = {"arch": arch, "shape": shape_name,
              "mesh": "multi" if multi_pod else "single",
              "mesh_shape": dict(mesh), "status": "ok",
              # the coded-matmul deployment this cell would run with
              "coded": {"scheme": cfg.coded.scheme,
                        "backend": cfg.coded.backend,
                        "out_sharded": cfg.coded.out_sharded}}
    with meshctx.use_mesh(mesh):
        _, args, specs, kinds = build_cell(cfg, shape_name, mesh, ce_chunk=ce_chunk)
    by_kind = {}
    for a, s, kind in zip(args, specs, kinds):
        by_kind[kind] = by_kind.get(kind, 0) + argument_bytes(a, s, mesh)
    del args

    if probes is None:  # the configs that scan over time
        probes = bool(cfg.rwkv) or cfg.ssm is not None
    if probes:
        m1 = _measure(_probe_cfg(cfg, 1), shape_name, mesh, ce_chunk, device)
        m2 = _measure(_probe_cfg(cfg, 2), shape_name, mesh, ce_chunk, device)
        m = _combine(m1, m2, cfg.num_groups)
        m["seconds"] = m1["seconds"] + m2["seconds"]
        if cfg.encoder_layers:  # the encoder's marginal layer, at 1 group
            enc2 = _measure(_probe_cfg(cfg, 1, enc_layers=2), shape_name, mesh, ce_chunk,
                            device)
            for k in m:
                if k != "seconds":
                    m[k] += (cfg.encoder_layers - 1) * max(enc2.get(k, 0.0) - m1[k], 0.0)
            m["seconds"] += enc2["seconds"]
        record["depth"] = "probes: 1 and 2 groups"
    else:
        m = _measure(cfg, shape_name, mesh, ce_chunk, device)
        record["depth"] = "full"
    record["meta_s"] = round(m["seconds"], 2)
    record["cost_analysis"] = {"flops_per_device": m["flops"],
                               "bytes_per_device": None, "transcendentals": None}
    arg = sum(by_kind.values())
    temp = int(m["temp"])
    record["memory_analysis"] = {
        "argument_bytes": arg, "output_bytes": int(m["out"]), "temp_bytes": temp,
        "alias_bytes": int(m["alias"]), "peak_bytes_est": arg + temp}
    record["argument_bytes_by_kind"] = by_kind
    record["collectives"] = _collectives(m)
    return record


def sweep_cell(arch: str, shape: str, multi_pod: bool, outdir: pathlib.Path,
               force: bool = False, mesh=None, cfg_override=None,
               verbose: bool = False) -> dict:
    """Run one cell and persist its record (ok, skipped, or error).

    A family that fails surfaces as an ``error`` record carrying the
    exception string, so the report renders it as a row instead of the
    family vanishing from the sweep.  The on-disk cache is keyed by (arch,
    shape, mesh kind) only, so a ``mesh``/``cfg_override`` call is never
    served from the cache: it always recomputes and overwrites.  Cache
    hits are marked ``cached``."""
    tag = f"{arch}__{shape}__{'multi' if multi_pod else 'single'}"
    path = pathlib.Path(outdir) / f"{tag}.json"
    ad_hoc = mesh is not None or cfg_override is not None
    if path.exists() and not force and not ad_hoc:
        return dict(json.loads(path.read_text()), cached=True)
    if verbose:
        print(f"[dryrun] {tag}: meta run...", flush=True)
    try:
        rec = run_cell(arch, shape, multi_pod, mesh=mesh, cfg_override=cfg_override)
    except Exception as e:  # noqa: BLE001 -- report and continue the sweep
        rec = {"arch": arch, "shape": shape,
               "mesh": "multi" if multi_pod else "single",
               "status": "error", "error": f"{type(e).__name__}: {e}"}
    path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=["all"] + list(SHAPES))
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--force", action="store_true", help="recompute existing")
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
                rec = sweep_cell(arch, shape, multi, outdir, force=args.force, verbose=True)
                if rec.get("cached"):
                    print(f"[dryrun] {tag}: cached")
                    continue
                status = rec["status"]
                extra = ""
                if status == "ok":
                    ma = rec["memory_analysis"]
                    extra = (f" meta={rec['meta_s']}s ({rec['depth']}) "
                             f"flops/dev={rec['cost_analysis']['flops_per_device']:.3g} "
                             f"arg={ma['argument_bytes']:.3g}B "
                             f"peak={ma['peak_bytes_est']:.3g}B "
                             f"coll={rec['collectives']['total_bytes']:.3g}B")
                elif status == "error":
                    failures += 1
                print(f"[dryrun] {tag}: {status}{extra}", flush=True)
    print(f"[dryrun] done, {failures} failures")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
