"""Structural contracts of the staged coded matmul, checked on captured programs.

The counterpart of the JAX package's ``src/repro/analysis/jaxpr_check.py``.
There a program is a staged jaxpr.  Here a *program* is the list of
``OpRecord``s that a ``ProgramCapture`` (a ``TorchDispatchMode``) records
around one call: one record per aten op that reaches dispatch, with its
name, its operands' and outputs' shapes and dtypes, and so its bytes.  The
four kernel entry points of ``repro_torch.kernels.ops`` are one record each
(``kernel=True``, named after the entry point), on both lanes, as a
``pallas_call`` is one equation: the ops they run inside are not recorded
(on the CPU lane the plain version is torch ops; on the CUDA lane the
ctypes launch is invisible to dispatch anyway).

The paper's structural guarantees are shape and dtype facts about such a
program, so they are checked without reading a value:

* ``stacked_intermediates`` -- nnz-proportional staging (Theorem 1): no
  output with a leading dimension of ``max_degree * s`` (the legacy
  stacked copy of B);
* ``decode_contraction_offenders`` / ``fused_epilogue_launches`` -- the
  decode combine rides the kernel's epilogue: no ``(mn, br, *)`` product
  outside a kernel record, and a kernel record that emits the
  ``(mn, br, bt)`` stack;
* ``worker_combines`` -- a one-process program sums a stack of all N
  workers' contributions into C: its counterpart of the reference's "no
  collective" check;
* ``collectives`` / ``collective_axis_offenders`` -- a rank's program of a
  worker group (``stage_coded_matmul(..., group=...)``) joins exactly one
  collective, of its decode layout's kind, over the worker group and no
  other: the reference's ``collective-axis`` rule, with the c10d ops that
  ``torch.distributed`` dispatches standing for its psum and psum_scatter;
* ``float64_offenders`` -- the pipeline is f32 end to end;
* ``peak_equation_bytes`` -- per-record operand + output bytes, held to
  ``nnz_proportional_budget`` (the reference's arithmetic).

Each detector has a sensitivity probe (``assert_*_sensitivity``): a
program built the legacy way, which it must flag.  ``run_contract_checks``
runs every probe before the live programs (the collective probe in the
ranks of the group, before their programs), so a blind detector fails the
run.  Every pass returns plain offender records; callers (tests, the CLI)
decide between asserting and emitting findings.
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.findings import ERROR, Finding
from repro_torch.kernels import coded_accum, ops, spmm_block

LAYER = "contracts"


# ------------------------------- the programs --------------------------------

Aval = tuple[tuple[int, ...], torch.dtype]


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One op of a captured program: an aten op, or one kernel entry point's
    call (``kernel=True``) standing for its launch."""

    name: str                  # "aten.mul.Tensor", or the entry point's name
    op: str                    # the op without its overload ("mul"), or the entry point's name
    inputs: tuple[Aval, ...]
    outputs: tuple[Aval, ...]
    kernel: bool = False
    group: str | None = None   # a collective's process group, by name


def _group_name(args) -> str | None:
    """The name of the process group a c10d op's arguments name (its other
    script objects, such as the reduce op, are not groups)."""
    for arg in args:
        if isinstance(arg, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(arg).group_name
            except RuntimeError:
                continue
    return None


def _avals(tree) -> tuple[Aval, ...]:
    leaves, _ = tree_flatten(tree)
    return tuple((tuple(x.shape), x.dtype) for x in leaves if isinstance(x, torch.Tensor))


class ProgramCapture(TorchDispatchMode):
    """Records every op that reaches dispatch while it is entered, and each
    kernel entry point's call as one record (``kernels.ops.KERNEL_SCOPE``)."""

    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []
        self._in_kernel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._in_kernel:
            self.records.append(OpRecord(
                str(func), func.overloadpacket.__name__, _avals((args, kwargs)), _avals(out),
                group=_group_name(args) if func.namespace == "c10d" else None))
        return out

    def kernel(self, name: str, operands: tuple, run):
        self._in_kernel += 1
        try:
            out = run()
        finally:
            self._in_kernel -= 1
        self.records.append(OpRecord(name, name, _avals(operands), _avals(out), kernel=True))
        return out


def capture(fn, *args, **kwargs) -> tuple[list[OpRecord], object]:
    """The program of one call ``fn(*args, **kwargs)``, and its result."""
    cap = ProgramCapture()
    token = ops.KERNEL_SCOPE.set(cap)
    try:
        with cap:
            out = fn(*args, **kwargs)
    finally:
        ops.KERNEL_SCOPE.reset(token)
    return cap.records, out


def launch_counts() -> dict[str, int]:
    """Every kernel's launches in this process so far."""
    return {**spmm_block.LAUNCHES, **coded_accum.LAUNCHES}


def capture_apply(op, A: torch.Tensor, B: torch.Tensor,
                  **kw) -> tuple[list[OpRecord], dict[str, int]]:
    """The program of one *warm* ``op(A, B, **kw)``, and the kernel launches
    it made.  An apply first fills the pack cache, so the capture sees what
    the JAX trace sees -- the pack as an operand -- and not the cache's
    host-to-device copies, which a cold apply would record."""
    op(A, B, **kw)
    before = launch_counts()
    program, _ = capture(op, A, B, **kw)
    return program, {k: v - before[k] for k, v in launch_counts().items()}


def walk_avals(program) -> Iterator[tuple[str, Aval]]:
    """(op, output aval) of every record, the kernel records included."""
    for rec in program:
        for aval in rec.outputs:
            yield rec.op, aval


def _records_outside_kernels(program) -> Iterator[OpRecord]:
    """The records that are not a kernel's: a decode combine inside a
    kernel record is the fused epilogue the one-launch contract wants,
    never an offender."""
    return (rec for rec in program if not rec.kernel)


# ------------------------- pass: no dense materialization --------------------

def stacked_intermediates(program, stacked_rows: int) -> list[tuple[str, tuple]]:
    """Offending (op, shape) pairs whose output has a leading dimension of
    exactly ``stacked_rows`` = ``max_degree * s`` -- the row count of the
    legacy stacked copy of B that the fused gather exists to avoid."""
    return [(op, shape) for op, (shape, _) in walk_avals(program)
            if shape and shape[0] == stacked_rows]


def legacy_stacked_gather(B: torch.Tensor, max_degree: int, s: int, n: int,
                          bt: int) -> torch.Tensor:
    """The OLD stacked construction (gather + transpose + reshape into a
    (max_degree * s, bt) stack) -- the detector's sensitivity probe, never
    an execution path."""
    first = torch.zeros(max_degree, dtype=torch.long, device=B.device)
    bsel = B.reshape(s, n, bt).index_select(1, first)
    return bsel.transpose(0, 1).reshape(max_degree * s, bt)


def assert_detector_sensitivity(max_degree: int, s: int, n: int, bt: int, *,
                                device="cpu", dtype=torch.float32) -> None:
    """Prove ``stacked_intermediates`` still flags the legacy construction
    (a detector gone blind would let the dense path come back unnoticed)."""
    B = torch.zeros((s, n * bt), dtype=dtype, device=device)
    program, _ = capture(legacy_stacked_gather, B, max_degree, s, n, bt)
    if not stacked_intermediates(program, max_degree * s):
        raise AssertionError(
            "program capture failed to flag the legacy stacked gather "
            f"(max_degree={max_degree}, s={s}): the no-dense-materialization "
            "detector has lost sensitivity")


# ----------------------- pass: one-launch decode epilogue --------------------

#: ops a decode combine staged outside the kernel can appear as: the
#: broadcast multiply of the legacy epilogue, a D @ C~ contraction (matmul
#: and einsum reach dispatch as these products), or a broadcast
_DECODE_OPS = ("mul", "mul_", "mm", "bmm", "addmm", "baddbmm", "expand")


def decode_contraction_offenders(program, mn: int, br: int) -> list[tuple[str, tuple]]:
    """Records OUTSIDE any kernel that build the decode-weighted stack: a
    multiply, product or broadcast with a rank-3 ``(mn, br, *)`` output.  On
    the one-launch path that stack may only be born inside the fused
    kernel's epilogue, so any hit means a separate decode pass (and a round
    trip of C~ through memory) came back.  ``mn == 1`` is skipped: a
    single-block decode is shape-indistinguishable from the local product."""
    if mn <= 1:
        return []
    return [(rec.op, shape) for rec in _records_outside_kernels(program)
            if rec.op in _DECODE_OPS
            for shape, _ in rec.outputs
            if len(shape) == 3 and shape[0] == mn and shape[1] == br]


def fused_epilogue_launches(program, mn: int) -> list[tuple]:
    """Output shapes of every kernel record that emits the decode-fused
    stack (rank 3, leading dim mn).  Empty means the program never ran the
    one-launch kernel -- the epilogue contract is vacuous without it."""
    return [shape for rec in program if rec.kernel
            for shape, _ in rec.outputs if len(shape) == 3 and shape[0] == mn]


def legacy_decode_combine(dvec: torch.Tensor, Ct: torch.Tensor) -> torch.Tensor:
    """The OLD two-step epilogue (broadcast multiply of the decode column
    against the local product) -- the decode detector's sensitivity probe,
    never an execution path."""
    return dvec[:, None, None] * Ct[None]


def assert_decode_detector_sensitivity(mn: int, br: int, bt: int, *, device="cpu",
                                       dtype=torch.float32) -> None:
    """Prove ``decode_contraction_offenders`` still flags the legacy
    two-step combine."""
    dvec = torch.zeros(mn, dtype=dtype, device=device)
    Ct = torch.zeros((br, bt), dtype=dtype, device=device)
    program, _ = capture(legacy_decode_combine, dvec, Ct)
    if not decode_contraction_offenders(program, mn, br):
        raise AssertionError(
            "program capture failed to flag the legacy decode combine "
            f"(mn={mn}, br={br}, bt={bt}): the one-launch-epilogue detector "
            "has lost sensitivity")


def verify_fused_epilogue(program, *, mn: int, br: int, context: str) -> list[Finding]:
    """The one-launch contract for a block_sparse program: the decode stack
    is born inside a kernel's epilogue and nowhere else."""
    path, line = _staging_anchor()

    def finding(message):
        return Finding(rule="one-launch-epilogue", severity=ERROR, path=path,
                       line=line, message=f"{context}: {message}", layer=LAYER)

    out = []
    offenders = decode_contraction_offenders(program, mn, br)
    if offenders:
        out.append(finding(
            f"separate decode contraction staged outside the kernel: "
            f"{offenders[:3]} -- the decode combine must ride the fused "
            "epilogue"))
    if mn > 1 and not fused_epilogue_launches(program, mn):
        out.append(finding(
            "no kernel launch emits the (mn, br, bt) decode-fused stack: the "
            "one-launch kernel never ran"))
    return out


# --------------------------- pass: the worker sum ----------------------------

#: the reduction that combines the workers' contributions (the psum of the
#: JAX package's mesh, on one card)
_COMBINE_OPS = ("sum",)


def worker_combines(program, num_workers: int) -> list[tuple[str, tuple, tuple]]:
    """(op, operand shape, output shape) of every sum of an operand whose
    leading dimension of ``num_workers`` it reduces away: the sum over the
    stack of all N workers' contributions.  Empty means the program never
    combined them."""
    return [(rec.op, shape, out) for rec in program
            if rec.op in _COMBINE_OPS
            for shape, _ in rec.inputs
            for out, _ in rec.outputs
            if shape and shape[0] == num_workers and out == shape[1:]]


def worker_zero_alone(contribs: list[torch.Tensor]) -> torch.Tensor:
    """A program that stacks the contributions and returns worker 0's
    alone -- the worker-combine detector's sensitivity probe, never an
    execution path."""
    return torch.stack(contribs)[0]


def assert_combine_detector_sensitivity(num_workers: int, mn: int, br: int, bt: int, *,
                                        device="cpu", dtype=torch.float32) -> None:
    """Prove ``worker_combines`` finds no combine in a program that drops
    every worker but one."""
    contribs = [torch.zeros((mn, br, bt), dtype=dtype, device=device)
                for _ in range(num_workers)]
    program, _ = capture(worker_zero_alone, contribs)
    if worker_combines(program, num_workers):
        raise AssertionError(
            "program capture counted worker 0's contribution alone as a sum "
            f"over the {num_workers} workers: the worker-combine detector has "
            "lost sensitivity")


# ------------------------ pass: collective axes (a rank) ---------------------

#: the collective each decode layout combines with, as its c10d op reaches
#: dispatch (the reference's psum and psum_scatter)
LAYOUT_COLLECTIVES = {"all_reduce": "allreduce_", "reduce_scatter": "reduce_scatter_"}


def layout_of(out_sharded: bool) -> str:
    return "reduce_scatter" if out_sharded else "all_reduce"


def collectives(program) -> list[tuple[str, str | None]]:
    """(op, group name) of every collective record of the program."""
    return [(rec.op, rec.group) for rec in program if rec.name.startswith("c10d.")]


def collective_axis_offenders(program, group: str) -> list[tuple[str, str | None]]:
    """Collectives over any process group but ``group`` (by name)."""
    return [(op, g) for op, g in collectives(program) if g != group]


def collective_axis_problems(program, *, group: str, layout: str,
                             axis_name: str = "model") -> list[str]:
    """What breaks the ``collective-axis`` rule in a rank's program: a
    collective over a group other than the worker group, and anything but
    exactly one collective of ``layout``'s kind."""
    out = []
    bad = collective_axis_offenders(program, group)
    if bad:
        out.append(f"collectives over groups other than the worker axis {axis_name!r} "
                   f"(process group {group!r}): {bad}")
    found = collectives(program)
    if not found:
        out.append("no collective in the staged program: worker contributions are "
                   "never combined")
    elif [op for op, _ in found] != [LAYOUT_COLLECTIVES[layout]]:
        out.append(f"the {layout} layout combines with exactly one {layout}, the "
                   f"program has {found}")
    return out


def wrong_group_combine(contrib: torch.Tensor, group) -> torch.Tensor:
    """A worker's contribution all-reduced over ``group``, which is not its
    worker group -- the collective detector's sensitivity probe, never an
    execution path."""
    dist.all_reduce(contrib, group=group)
    return contrib


def uncombined(contrib: torch.Tensor) -> torch.Tensor:
    """A worker's contribution returned as C with no collective -- the
    collective detector's other probe, never an execution path."""
    return contrib.clone()


def assert_collective_detector_sensitivity(worker_group, other_group, mn: int, br: int,
                                           bt: int, *, device="cpu") -> None:
    """Prove ``collective_axis_problems`` flags an all-reduce over a group
    that is not the worker group, and a program with no collective.  Every
    rank of ``other_group`` calls it."""
    contrib = torch.zeros((mn, br, bt), device=device)
    wrong, _ = capture(wrong_group_combine, contrib, other_group)
    alone, _ = capture(uncombined, contrib)
    for what, program in (("an all-reduce over another group", wrong),
                          ("a program with no collective", alone)):
        if not collective_axis_problems(program, group=worker_group.group_name,
                                        layout="all_reduce"):
            raise AssertionError(
                f"program capture failed to flag {what}: the collective-axis "
                "detector has lost sensitivity")


# ----------------------------- pass: dtype policy ----------------------------

def float64_offenders(program) -> list[tuple[str, tuple, str]]:
    """(op, shape, dtype) of every f64 intermediate.  The device path is an
    f32 pipeline end to end (decode matrices are staged as f32); an f64
    output means a silent promotion leaked into the program."""
    return [(op, shape, str(dtype).removeprefix("torch."))
            for op, (shape, dtype) in walk_avals(program) if dtype == torch.float64]


def float64_decode_combine(dvec: torch.Tensor, Ct: torch.Tensor) -> torch.Tensor:
    """The decode combine promoted to f64 and cast back -- the dtype
    detector's sensitivity probe, never an execution path."""
    return (dvec.double()[:, None, None] * Ct.double()[None]).float()


def assert_dtype_detector_sensitivity(mn: int, br: int, bt: int, *,
                                      device="cpu") -> None:
    """Prove ``float64_offenders`` still flags an f64 intermediate."""
    dvec = torch.zeros(mn, device=device)
    Ct = torch.zeros((br, bt), device=device)
    program, _ = capture(float64_decode_combine, dvec, Ct)
    if not float64_offenders(program):
        raise AssertionError(
            "program capture failed to flag an f64 decode combine: the "
            "dtype-policy detector has lost sensitivity")


# ------------------------- pass: peak-bytes accounting -----------------------

def _aval_bytes(aval: Aval) -> int:
    shape, dtype = aval
    return int(np.prod(shape, dtype=np.int64)) * dtype.itemsize


def peak_equation_bytes(program) -> tuple[int, str, list[tuple]]:
    """Max over records of (operand + output bytes); returns (bytes, op,
    shapes) of the peak record.  The static proxy for peak live memory: a
    record that touches a max_degree-times-blown-up operand shows up here,
    which is the conservatism a gate wants."""
    peak, peak_op, peak_shapes = 0, "<empty>", []
    for rec in program:
        avals = (*rec.inputs, *rec.outputs)
        total = sum(_aval_bytes(a) for a in avals)
        if total > peak:
            peak, peak_op, peak_shapes = total, rec.op, [shape for shape, _ in avals]
    return peak, peak_op, peak_shapes


def nnz_proportional_budget(plan, pack, s: int, r: int, t: int,
                            slack: float = 2.0) -> int:
    """Byte budget for one record of a block_sparse program: the operands,
    the packed live tiles, the (padded) decode contribution, and the result
    -- nothing in the program may touch more than ``slack`` times their
    sum.  The legacy stacked copy of B (``max_degree * s`` rows) blows past
    this the moment max_degree exceeds n.  The JAX package's arithmetic,
    term for term (``jaxpr_check.nnz_proportional_budget``)."""
    N = plan.num_workers
    m, n = plan.m, plan.n
    br, bt = r // m, t // n
    mn_pad = -(-m * n // N) * N
    itemsize = 4  # the pipeline is f32 end to end (the dtype pass enforces it)
    terms = [
        s * r,                      # A
        s * t,                      # B
        int(np.prod(tuple(pack.vals.shape))) if pack is not None else 0,
        mn_pad * br * bt,           # per-worker decode contribution
        m * br * n * bt,            # the assembled C
    ]
    return int(slack * itemsize * sum(terms))


def over_budget_op(byte_budget: int, device="cpu") -> torch.Tensor:
    """One op that touches a byte more than ``byte_budget`` -- the budget
    detector's sensitivity probe, never an execution path."""
    return torch.zeros(byte_budget // 4 + 1, device=device).add(1.0)


def assert_budget_detector_sensitivity(byte_budget: int, *, device="cpu") -> None:
    """Prove ``peak_equation_bytes`` still sees an op past the budget."""
    program, _ = capture(over_budget_op, byte_budget, device)
    if peak_equation_bytes(program)[0] <= byte_budget:
        raise AssertionError(
            f"program capture failed to see an op past {byte_budget} bytes: "
            "the memory-budget detector has lost sensitivity")


# ------------------------ the kernel records, on the card ---------------------

def kernel_launch_offenders(program, launches: dict[str, int]) -> list[tuple[str, int, int]]:
    """(kernel, records, launches) wherever the program's kernel records
    and the kernels' launch counts of the same call disagree.  On the CUDA
    lane each record is one launch; the CPU lane launches nothing."""
    records = collections.Counter(rec.name for rec in program if rec.kernel)
    return [(name, records[name], launches.get(name, 0))
            for name in sorted(set(records) | set(launches))
            if records[name] != launches.get(name, 0)]


# ------------------------------ the CLI's layer ------------------------------

def _staging_anchor() -> tuple[str, int]:
    """file:line of ``stage_coded_matmul`` -- the one place every verified
    program is staged from, hence the anchor of contract findings."""
    from repro_torch.core import coded_matmul

    try:
        _, line = inspect.getsourcelines(coded_matmul.stage_coded_matmul)
    except OSError:  # pragma: no cover - source unavailable (zipapp etc.)
        line = 0
    return "core/coded_matmul.py", line


def verify_staged_program(program, *, num_workers: int, stacked_rows: int | None,
                          byte_budget: int | None, context: str, group: str | None = None,
                          layout: str = "all_reduce",
                          axis_name: str = "model") -> list[Finding]:
    """Run every applicable pass over one captured program; findings only.

    ``group`` (a process group's name) marks a rank's program of a worker
    group, held to ``collective-axis`` for its ``layout``; a one-process
    program (None) is held to ``worker-combine``."""
    path, line = _staging_anchor()

    def finding(rule, message, severity=ERROR):
        return Finding(rule=rule, severity=severity, path=path, line=line,
                       message=f"{context}: {message}", layer=LAYER)

    out = []
    if stacked_rows is not None:
        offenders = stacked_intermediates(program, stacked_rows)
        if offenders:
            out.append(finding(
                "no-dense-materialization",
                f"program materializes {stacked_rows}-row intermediates "
                f"(max_degree * s): {offenders[:3]}"))
    if group is not None:
        out.extend(finding("collective-axis", problem) for problem in collective_axis_problems(
            program, group=group, layout=layout, axis_name=axis_name))
    elif not worker_combines(program, num_workers):
        out.append(finding(
            "worker-combine",
            f"no sum over the {num_workers} workers' contributions in the "
            "program: worker contributions are never combined"))
    f64 = float64_offenders(program)
    if f64:
        out.append(finding(
            "dtype-policy",
            f"float64 intermediates in the f32 pipeline: {f64[:3]}"))
    if byte_budget is not None:
        peak, op, shapes = peak_equation_bytes(program)
        if peak > byte_budget:
            out.append(finding(
                "memory-budget",
                f"peak op touches {peak} bytes > nnz-proportional budget "
                f"{byte_budget} (op {op}, shapes {shapes[:4]})"))
    return out


#: the geometry of the live programs: the JAX package's CLI geometry, and N
#: for the schemes whose worker count is free (the reference takes
#: max(devices, mn + 2) on its forced 8-device host; one card has no device
#: count to fall short of)
GEOMETRY = dict(m=2, n=2, s=32, bs=8, seed=5)
FREE_WORKERS = 8
#: the worker group's programs: ranks of one gloo group of FREE_WORKERS,
#: the fixed-worker schemes each on a subgroup of their N ranks
GROUP_BACKEND = "gloo"
GROUP_TIMEOUT_S = 300.0


def _cli_operands():
    """The live programs' A, B (numpy) and A's block-ELL."""
    from repro_torch.sparse.blocksparse import dense_to_block_ell

    m, n, s, bs = (GEOMETRY[k] for k in ("m", "n", "s", "bs"))
    rng = np.random.default_rng(0)
    r, t = 8 * m, 12 * n
    A_np = rng.standard_normal((s, r)).astype(np.float32)
    mask = rng.random((s // bs, r // bs)) < 0.5
    A_np *= np.kron(mask, np.ones((bs, bs), np.float32))
    B_np = rng.standard_normal((s, t)).astype(np.float32)
    return A_np, B_np, dense_to_block_ell(A_np, block_size=bs)


def _device_plans() -> list[tuple[str, object]]:
    """(scheme name, plan) of every device-capable registered scheme."""
    from repro_torch.coded import get_scheme, scheme_names

    m, n = GEOMETRY["m"], GEOMETRY["n"]
    out = []
    for name in scheme_names():
        sch = get_scheme(name)
        try:
            plan = sch.plan(m, n, None if sch.fixed_workers else FREE_WORKERS,
                            seed=GEOMETRY["seed"])
        except ValueError:
            continue  # not device-capable (e.g. mds): nothing to stage
        out.append((name, plan))
    return out


class _Checker:
    """Captures live programs on one device and verifies each."""

    def __init__(self, device: torch.device, A_np, B_np, ell):
        self.device = device
        self.A = torch.from_numpy(A_np).to(device)
        self.B = torch.from_numpy(B_np).to(device)
        self.ell = ell
        self.path, self.line = _staging_anchor()
        self.findings: list[Finding] = []
        self.programs = 0

    def captured(self, op, kw, context):
        program, launches = capture_apply(op, self.A, self.B, **kw)
        if self.device.type == "cuda":
            bad = kernel_launch_offenders(program, launches)
            if bad:
                self.findings.append(Finding(
                    rule="kernel-scope", severity=ERROR, path=self.path, line=self.line,
                    layer=LAYER, message=f"{context}: kernel records disagree with "
                                         f"the launches (kernel, records, launches): {bad}"))
        return program

    def staged(self, name, plan, group=None):
        """Every backend x layout program of one plan; with ``group``, this
        rank's programs of the worker group."""
        from repro_torch.coded import CodedMatmulConfig, from_plan
        from repro_torch.core.coded_matmul import pack_worker_tiles

        m, n, s = GEOMETRY["m"], GEOMETRY["n"], GEOMETRY["s"]
        r, t = self.A.shape[1], self.B.shape[1]
        budget = nnz_proportional_budget(plan, pack_worker_tiles(self.ell, plan), s, r, t)
        for backend in ("dense_scan", "block_sparse"):
            kw = {"a_sparse": self.ell} if backend == "block_sparse" else {}
            for out_sharded in (False, True):
                cfg = CodedMatmulConfig(backend=backend, out_sharded=out_sharded)
                op = from_plan(cfg, plan).bind(self.device, group=group)
                context = f"scheme={name} backend={backend} out_sharded={out_sharded}"
                if group is not None:
                    context += (f" {cfg.axis_name}=rank {dist.get_rank(group)} of "
                                f"{dist.get_world_size(group)}")
                # max_degree == 1 would make the stacked row count collide
                # with the operands' own (s, ...) shapes: nothing to detect
                self.findings.extend(verify_staged_program(
                    self.captured(op, kw, context), num_workers=plan.num_workers,
                    stacked_rows=(plan.max_degree * s if backend == "block_sparse"
                                  and plan.max_degree > 1 else None),
                    byte_budget=budget if backend == "block_sparse" else None,
                    context=context,
                    group=None if group is None else group.group_name,
                    layout=layout_of(out_sharded), axis_name=cfg.axis_name))
                self.programs += 1
                if backend != "block_sparse" or out_sharded or group is not None:
                    continue
                # the one-launch contract, on the program's own lane: the
                # kernel scope records the launch on both
                context = f"scheme={name} backend={backend} one-launch"
                self.findings.extend(verify_fused_epilogue(
                    self.captured(op, kw, context), mn=m * n, br=r // m, context=context))
                self.programs += 1


def _group_programs_rank(device, A_np, B_np, ell, plans) -> dict:
    """One rank of the worker group's programs: the collective probe first,
    then this rank's program of every plan x backend x layout, over the
    world group or, for a plan of fewer workers, over the subgroup of
    consecutive ranks that holds this rank.  Returns its findings, its
    count of programs and its process's kernel launches (warm applies
    included)."""
    world = dist.group.WORLD
    rank, size = dist.get_rank(), dist.get_world_size()
    # every rank makes every subgroup, in the same order (new_group's rule)
    tilings = {N: [dist.new_group(list(range(i, i + N))) for i in range(0, size, N)]
               for N in sorted({size // 2, *(p.num_workers for _, p in plans)})
               if N < size and size % N == 0}
    checker = _Checker(device, A_np, B_np, ell)
    try:
        assert_collective_detector_sensitivity(
            tilings[size // 2][rank // (size // 2)], world, 4, 8, 12, device=device)
    except AssertionError as exc:
        checker.findings.append(Finding(rule="collective-axis", severity=ERROR,
                                        path=checker.path, line=checker.line,
                                        layer=LAYER, message=f"rank {rank}: {exc}"))
        return {"findings": checker.findings, "programs": 0, "launches": {}}
    for name, plan in plans:
        N = plan.num_workers
        group = world if N == size else tilings[N][rank // N]
        checker.staged(name, plan, group=group)
    return {"findings": checker.findings, "programs": checker.programs,
            "launches": launch_counts()}


def run_contract_checks(device, launches_out: dict | None = None) -> tuple[list[Finding], int]:
    """Capture coded matmuls for every device-capable registered scheme
    across backends x decode layouts on ``device``, and verify each
    program; plus one one-launch program for each scheme's block_sparse;
    then each such scheme's backend x layout programs in the ranks of a
    gloo worker group of ``FREE_WORKERS`` (``runtime.workergroup``), rank 0's
    counted.  Returns (findings, programs_verified).  On a CUDA device each
    program's kernel records are also held to the launches it made.
    ``launches_out``, where given, gets the ranks' kernel launches (this
    process's are ``launch_counts()``)."""
    from repro_torch.runtime.workergroup import spawn_group

    device = torch.device(device)
    path, line = _staging_anchor()
    findings: list[Finding] = []

    # detector self-tests first: a blind detector must fail the run, not
    # silently bless it (the collective probe runs first in each rank)
    probes = (
        ("no-dense-materialization",
         lambda: assert_detector_sensitivity(6, 32, 2, 12, device=device)),
        ("one-launch-epilogue",
         lambda: assert_decode_detector_sensitivity(4, 8, 12, device=device)),
        ("worker-combine",
         lambda: assert_combine_detector_sensitivity(FREE_WORKERS, 4, 8, 12, device=device)),
        ("dtype-policy", lambda: assert_dtype_detector_sensitivity(4, 8, 12, device=device)),
        ("memory-budget", lambda: assert_budget_detector_sensitivity(1 << 15, device=device)),
    )
    for rule, probe in probes:
        try:
            probe()
        except AssertionError as exc:
            findings.append(Finding(rule=rule, severity=ERROR, path=path, line=line,
                                    layer=LAYER, message=str(exc)))
            return findings, 0

    A_np, B_np, ell = _cli_operands()
    plans = _device_plans()
    ranks = []
    if plans:
        ranks = spawn_group(_group_programs_rank, FREE_WORKERS, backend=GROUP_BACKEND,
                            device=device, timeout=GROUP_TIMEOUT_S,
                            args=(A_np, B_np, ell, plans))
        for rank in ranks:
            findings.extend(rank["findings"])
        if launches_out is not None:
            for rank in ranks:
                for k, v in rank["launches"].items():
                    launches_out[k] = launches_out.get(k, 0) + v
        if any(f.rule == "collective-axis" and "lost sensitivity" in f.message
               for f in findings):
            return findings, 0

    checker = _Checker(device, A_np, B_np, ell)
    for name, plan in plans:
        checker.staged(name, plan)
    return findings + checker.findings, checker.programs + (ranks[0]["programs"] if ranks else 0)
