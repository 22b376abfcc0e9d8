"""Static validator for registered code schemes and their device plans.

The paper's guarantees are properties of the generator matrix, so every one
of them is checked here *without executing a multiply*:

* **recovery threshold** (Theorems 1-2): over seeded random arrival orders,
  the number of workers needed before the collected rows decode must stay
  within the scheme's declared bound (``SchemeInvariants``: exact for MDS
  designs, optimum + bounded overhead for the sparse/LT families);
* **degree / weight sanity**: no empty or over-full generator rows, finite
  nonzero stored weights, sparse designs keep O(log mn) mean row weight,
  and per-worker cost factors match the row structure;
* **chunk-expand exactness** (the chunked-protocol refinement): for every
  scheme and chunk count, the chunk rows of each parent row have disjoint
  supports and sum back to the parent EXACTLY -- the identity that makes a
  completed chunk a usable equation;
* **decode conditioning under worst-case survivor prefixes**: the decode
  matrix is applied in f32 on device, so the condition number of the
  surviving coefficient rows -- for minimal survivor subsets and for
  partial chunk prefixes -- must stay within float budget, and
  ``plan.decode`` must be a genuine left inverse;
* **BlockELL / tile-pack consistency**: packed tile indices stay in range,
  padding slots carry zero weight AND zero values, ``slot_of`` maps every
  live tile back to a live task slot, and the ELL round-trips to the dense
  operand bit-for-bit.

Everything here is generator-matrix math (numpy) over the port's registry,
plans and packs; nothing stages or runs device code.  The checks are the
JAX package's (the same rng draws, the same messages), so a scheme's
findings compare with the reference's; ``check_pack`` also takes a
caller's operand and pack at any size (``validate_pack``).
"""

from __future__ import annotations

import dataclasses
import inspect
import zlib
from pathlib import Path

import numpy as np

from repro_torch.analysis.findings import ERROR, WARNING, Finding
from repro_torch.core.encoder import chunk_expand
from repro_torch.core.schemes import SchemeInvariants

#: the (m, n, N) sweep every registered scheme is validated over
DEFAULT_CONFIGS: tuple[tuple[int, int, int], ...] = (
    (2, 2, 8),
    (2, 3, 12),
    (3, 3, 18),
)
DEFAULT_CHUNKS: tuple[int, ...] = (1, 2, 3)

#: additive slack on top of the fractional overhead bounds: tiny codes are
#: granular (one worker can be a whole +25% at mn=4), so a pure fraction
#: would be noise-driven
THRESHOLD_SLACK_WORKERS = 2

COND_ERROR = 1e12   # decode is numerically meaningless at any precision

#: instance seeds sampled for probabilistic (non-exact) designs -- LT-style
#: peeling decode is ALLOWED to fail for an unlucky sample, so decodability
#: is judged across seeds, not on one draw
SEED_SAMPLES = (0, 1, 2, 3, 4)

#: fallback profile for custom-registered schemes that declared nothing
PERMISSIVE = SchemeInvariants(mean_overhead=2.0, max_overhead=4.0,
                              dense_rows=True)


def _builder_anchor(scheme) -> tuple[str, int]:
    """file:line of the scheme's registered builder -- the code a scheme
    finding should point the author at."""
    try:
        src = inspect.getsourcefile(scheme.builder)
        _, line = inspect.getsourcelines(scheme.builder)
        import repro_torch

        pkg = Path(repro_torch.__file__).resolve().parent
        path = Path(src).resolve()
        rel = (path.relative_to(pkg).as_posix()
               if pkg in path.parents else str(path))
        return rel, line
    except (OSError, TypeError):  # pragma: no cover - builtins/partials
        return "coded/registry.py", 0


@dataclasses.dataclass
class _Ctx:
    """One scheme under validation: shared anchors and finding sink."""

    name: str
    scheme: object
    inv: SchemeInvariants
    findings: list[Finding]
    path: str = ""
    line: int = 0

    def __post_init__(self):
        self.path, self.line = _builder_anchor(self.scheme)

    def add(self, rule: str, message: str, severity: str = ERROR) -> None:
        self.findings.append(Finding(
            rule=rule, severity=severity, path=self.path, line=self.line,
            message=f"scheme {self.name!r}: {message}", layer="schemes"))


# ----------------------------- threshold check ------------------------------

def _measure_thresholds(inst, optimal: int, trials: int,
                        rng: np.random.Generator) -> np.ndarray | None:
    """Workers needed until decodable, over random arrival orders.
    None when even the full worker set cannot decode."""
    N = inst.num_workers
    if not inst.can_decode(list(range(N))):
        return None
    out = np.empty(trials, dtype=np.int64)
    for t in range(trials):
        order = rng.permutation(N).tolist()
        lo = optimal
        got = N
        for k in range(lo, N + 1):
            if inst.can_decode(order[:k]):
                got = k
                break
        out[t] = got
    return out


def check_recovery_threshold(ctx: _Ctx, make_inst, inst, m: int, n: int,
                             trials: int, rng: np.random.Generator) -> None:
    """Empirical recovery threshold vs the declared bound.

    Exact designs are judged on the seed-0 instance: ANY optimal-size subset
    must decode, deterministically.  Probabilistic designs (LT-style peeling
    in particular) are judged across ``SEED_SAMPLES`` instance draws --
    one undecodable sample is within the design's failure probability, a
    majority is a broken code.
    """
    inv = ctx.inv
    optimal = inv.optimal(m, n, inst.num_workers)
    tag = f"(m={m}, n={n}, N={inst.num_workers})"
    if inv.exact:
        thresholds = _measure_thresholds(inst, optimal, trials, rng)
        if thresholds is None:
            ctx.add("recovery-threshold",
                    f"{tag} not decodable even from ALL workers")
        elif int(thresholds.max()) != optimal:
            ctx.add("recovery-threshold",
                    f"{tag} declared exact (any {optimal} workers decode) "
                    f"but a sampled arrival order needed "
                    f"{int(thresholds.max())}")
        return
    per_seed = max(4, trials // len(SEED_SAMPLES))
    samples, fails = [], 0
    for seed in SEED_SAMPLES:
        th = _measure_thresholds(inst if seed == 0 else make_inst(seed),
                                 optimal, per_seed, rng)
        if th is None:
            fails += 1
        else:
            samples.append(th)
    if fails * 2 > len(SEED_SAMPLES):
        ctx.add("recovery-threshold",
                f"{tag} {fails}/{len(SEED_SAMPLES)} sampled instances are "
                "not decodable even from ALL workers: failure probability "
                "far above the design's")
        return
    if not samples:
        return
    thresholds = np.concatenate(samples)
    mean_cap = optimal + inv.mean_overhead * optimal + THRESHOLD_SLACK_WORKERS
    max_cap = optimal + inv.max_overhead * optimal + THRESHOLD_SLACK_WORKERS
    if thresholds.mean() > mean_cap:
        ctx.add("recovery-threshold",
                f"{tag} mean recovery threshold {thresholds.mean():.2f} "
                f"workers exceeds the declared bound {mean_cap:.2f} "
                f"(optimum {optimal} + {inv.mean_overhead:.0%} overhead)")
    if thresholds.max() > max_cap:
        ctx.add("recovery-threshold",
                f"{tag} worst sampled threshold {int(thresholds.max())} "
                f"workers exceeds the declared bound {max_cap:.2f}")


# --------------------------- degree / weight sanity -------------------------

def check_degree_weights(ctx: _Ctx, inst, m: int, n: int) -> None:
    d = m * n
    M = inst.M.tocsr()
    degrees = np.diff(M.indptr)
    tag = f"(m={m}, n={n}, N={inst.num_workers})"
    if (degrees == 0).any():
        ctx.add("degree-sanity",
                f"{tag} generator rows {np.flatnonzero(degrees == 0).tolist()} "
                "are empty: a worker with no task is pure overhead")
    if (degrees > d).any():
        ctx.add("degree-sanity",
                f"{tag} generator row degree exceeds mn={d} "
                "(duplicate column indices in a row?)")
    if M.nnz and (~np.isfinite(M.data)).any():
        ctx.add("weight-sanity", f"{tag} non-finite generator weights")
    if M.nnz and (M.data == 0.0).any():
        ctx.add("weight-sanity",
                f"{tag} explicitly stored zero weights: dead slots inflate "
                "every worker's cost factor")
    if not ctx.inv.dense_rows and degrees.size:
        cap = 3.0 * np.log(max(d, 2)) + 3.0
        if degrees.mean() > cap:
            ctx.add("degree-sanity",
                    f"{tag} mean row degree {degrees.mean():.2f} exceeds the "
                    f"sparse-design cap {cap:.2f} (~O(log mn), Theorem 1's "
                    "per-worker cost)")
    cf = np.asarray(inst.cost_factor, dtype=np.float64)
    if cf.shape[0] != inst.num_workers:
        ctx.add("cost-sanity",
                f"{tag} cost_factor has {cf.shape[0]} entries for "
                f"{inst.num_workers} workers")
    elif (~np.isfinite(cf)).any() or (cf <= 0).any():
        ctx.add("cost-sanity", f"{tag} cost factors must be finite and "
                               "positive")
    elif not ctx.inv.dense_rows and all(
            len(rows) == 1 for rows in inst.worker_rows):
        per_worker_deg = np.asarray(
            [degrees[rows[0]] for rows in inst.worker_rows], dtype=np.float64)
        if not np.allclose(cf, per_worker_deg):
            ctx.add("cost-sanity",
                    f"{tag} sum-of-products cost factors must equal row "
                    "degrees (paper Table I)")


# --------------------------- chunk-expand exactness -------------------------

def check_chunk_exactness(ctx: _Ctx, inst, m: int, n: int,
                          chunks: tuple[int, ...]) -> None:
    M = inst.M.tocsr()
    dense = M.toarray()
    tag = f"(m={m}, n={n}, N={inst.num_workers})"
    for q in chunks:
        E = chunk_expand(M, q)
        if E.shape != (M.shape[0] * q, M.shape[1]):
            ctx.add("chunk-exactness",
                    f"{tag} chunk_expand(q={q}) shape {E.shape} != "
                    f"{(M.shape[0] * q, M.shape[1])}")
            continue
        Ed = E.toarray()
        for r in range(M.shape[0]):
            group = Ed[r * q:(r + 1) * q]
            if not np.array_equal(group.sum(axis=0), dense[r]):
                ctx.add("chunk-exactness",
                        f"{tag} q={q}: chunk rows of generator row {r} do "
                        "not sum back to the parent row exactly")
                break
            support = (group != 0).sum(axis=0)
            if (support > 1).any():
                ctx.add("chunk-exactness",
                        f"{tag} q={q}: chunk rows of generator row {r} have "
                        "overlapping supports (a slot computed twice)")
                break


# ------------------- plan: decode exactness + conditioning ------------------

def _cond(M_rows: np.ndarray) -> float:
    sv = np.linalg.svd(M_rows, compute_uv=False)
    if sv.size == 0 or sv[-1] <= 0:
        return np.inf
    return float(sv[0] / sv[-1])


def check_plan_decode(ctx: _Ctx, plan, m: int, n: int, trials: int,
                      rng: np.random.Generator) -> None:
    """Left-inverse exactness plus conditioning of the worst-case survivor
    subsets and chunk prefixes the runtime may hand to ``with_survivors``."""
    from repro_torch.core.decoder import DecodingError

    d = m * n
    N = plan.num_workers
    M = plan.coefficient_matrix()
    tag = f"(m={m}, n={n}, N={N})"
    resid = float(np.abs(plan.decode.astype(np.float64) @ M - np.eye(d)).max())
    if resid > 1e-3:
        ctx.add("decode-exactness",
                f"{tag} plan.decode is not a left inverse of the coefficient "
                f"matrix (max residual {resid:.2e})")

    worst = _cond(M)
    optimal = d  # one row per device on the SPMD path
    for _ in range(trials):
        surv = np.zeros(N, dtype=bool)
        surv[rng.choice(N, size=min(N, optimal + 1), replace=False)] = True
        M_surv = M[surv]
        if np.linalg.matrix_rank(M_surv) < d:
            continue  # not a decodable subset; with_survivors would refuse it
        worst = max(worst, _cond(M_surv))
    # partial chunk prefixes: the chunked protocol's worst case is a decode
    # from barely-enough completed chunks
    q = 2
    for _ in range(trials):
        progress = np.full(N, q)
        idx = rng.choice(N, size=min(N, 2), replace=False)
        progress[idx] = rng.integers(0, q, size=idx.size)
        try:
            masked = plan.with_chunk_progress(progress, q)
        except (DecodingError, ValueError):
            continue
        worst = max(worst, _cond(masked.coefficient_matrix()))
    if not np.isfinite(worst) or worst > COND_ERROR:
        ctx.add("decode-conditioning",
                f"{tag} worst-case survivor conditioning {worst:.2e} exceeds "
                f"{COND_ERROR:.0e}: the f32 device decode cannot represent "
                "this inverse")
    elif worst > ctx.inv.cond_warn:
        ctx.add("decode-conditioning",
                f"{tag} worst-case survivor conditioning {worst:.2e} exceeds "
                f"the scheme's declared budget {ctx.inv.cond_warn:.0e}: f32 "
                "decode accuracy is marginal", severity=WARNING)


# ----------------------- BlockELL / tile-pack consistency -------------------

def check_pack_consistency(ctx: _Ctx, plan, m: int, n: int,
                           rng: np.random.Generator) -> None:
    """Pack a deterministic sparse operand under this plan and verify every
    index-range/shape/padding contract of BlockELL and WorkerTilePack."""
    from repro_torch.core.coded_matmul import pack_worker_tiles
    from repro_torch.sparse.blocksparse import dense_to_block_ell

    bs = 4
    s, br = 16, 8
    r = m * br
    A = rng.standard_normal((s, r)).astype(np.float32)
    tile_mask = rng.random((s // bs, r // bs)) < 0.5
    A *= np.kron(tile_mask, np.ones((bs, bs), np.float32))
    ell = dense_to_block_ell(A, block_size=bs)
    check_pack(ctx, plan, n, A, ell, pack_worker_tiles(ell, plan))


def check_pack(ctx: _Ctx, plan, n: int, A: np.ndarray, ell, pack) -> None:
    """The contracts of one BlockELL of the dense operand ``A`` and of its
    ``WorkerTilePack`` under ``plan``, whatever their size.  The pack's
    ``vals`` is a CPU torch tensor (f32, bf16 or int8): its values are
    read as f32, which holds each of them exactly."""
    from repro_torch.sparse.blocksparse import block_ell_to_dense

    bs = ell.block_size
    s, r = A.shape
    br = r // plan.m
    tag = f"(m={plan.m}, n={n}, N={plan.num_workers})"

    RB = s // bs
    if int(ell.idx.max(initial=0)) >= RB or int(ell.idx.min(initial=0)) < 0:
        ctx.add("pack-consistency",
                f"{tag} BlockELL row-block indices out of [0, {RB})")
    if (ell.nnzb > ell.slots).any():
        ctx.add("pack-consistency",
                f"{tag} BlockELL nnzb exceeds the slot count")
    if not np.array_equal(block_ell_to_dense(ell), A):
        ctx.add("pack-consistency",
                f"{tag} BlockELL does not round-trip the dense operand")

    vals = pack.vals.float().numpy()
    N, L = plan.cols.shape
    CBl = br // bs
    if vals.shape[:3] != pack.src.shape[:3] or \
            vals.shape[:3] != pack.wslot.shape:
        ctx.add("pack-consistency",
                f"{tag} pack vals/src/wslot leading shapes disagree: "
                f"{vals.shape} vs {pack.src.shape} vs {pack.wslot.shape}")
        return
    if vals.shape[0] != N or vals.shape[1] != CBl:
        ctx.add("pack-consistency",
                f"{tag} pack is laid out for {vals.shape[0]} workers x "
                f"{vals.shape[1]} column blocks, plan needs {N} x {CBl}")
        return
    live = pack.wslot != 0.0
    if int(pack.src[..., 0].max(initial=0)) >= RB:
        ctx.add("pack-consistency",
                f"{tag} pack row-block addresses exceed s/bs={RB}: the "
                "fused gather would read out of range (XLA clamps silently)")
    if int(pack.src[..., 1].max(initial=0)) >= n:
        ctx.add("pack-consistency",
                f"{tag} pack column-group addresses exceed n={n}")
    if np.abs(vals[~live]).max(initial=0.0) != 0.0:
        ctx.add("pack-consistency",
                f"{tag} padding slots (zero weight) carry nonzero tile "
                "values: pads must contribute exactly nothing")
    if not np.array_equal(pack.live_tiles, live.sum(axis=(1, 2))):
        ctx.add("pack-consistency",
                f"{tag} live_tiles does not count the nonzero-weight slots")
    if pack.slot_of is None:
        ctx.add("pack-consistency",
                f"{tag} pack has no slot_of map: chunk-masked plans cannot "
                "re-gather weights (block_sparse would refuse this pack)")
    else:
        if int(pack.slot_of.max(initial=0)) >= L:
            ctx.add("pack-consistency",
                    f"{tag} slot_of exceeds the task table width {L}")
        k_idx = np.arange(N)[:, None, None]
        regathered = plan.weights[k_idx, pack.slot_of]
        if not np.array_equal(np.where(live, regathered, 0.0), pack.wslot):
            ctx.add("pack-consistency",
                    f"{tag} re-gathering weights through slot_of does not "
                    "reproduce wslot: chunk rebinds would compute with "
                    "wrong weights")


def validate_pack(plan, A: np.ndarray, ell, pack,
                  scheme: str = "sparse_code") -> list[Finding]:
    """``check_pack`` on a caller's operand (any size), its findings
    anchored at the registered builder of ``scheme``."""
    from repro_torch.coded.registry import get_scheme

    sch = get_scheme(scheme)
    ctx = _Ctx(name=scheme, scheme=sch, inv=sch.invariants or PERMISSIVE,
               findings=[])
    check_pack(ctx, plan, plan.n, A, ell, pack)
    return ctx.findings


# ------------------------------ entry points --------------------------------

def validate_scheme(name: str, *,
                    configs=DEFAULT_CONFIGS, chunks=DEFAULT_CHUNKS,
                    trials: int = 20) -> list[Finding]:
    """Every static check for one registered scheme, across the sweep."""
    from repro_torch.coded.registry import get_scheme

    scheme = get_scheme(name)
    ctx = _Ctx(name=name, scheme=scheme,
               inv=scheme.invariants or PERMISSIVE, findings=[])
    for m, n, N in configs:
        # crc32, not hash(): str hashing is salted per process and findings
        # must be reproducible run to run
        rng = np.random.default_rng(zlib.crc32(f"{name}:{m}:{n}:{N}".encode()))

        def make_inst(seed):
            return scheme.instance(m, n, None if scheme.fixed_workers else N,
                                   seed=seed)

        inst = make_inst(0)
        check_recovery_threshold(ctx, make_inst, inst, m, n, trials, rng)
        check_degree_weights(ctx, inst, m, n)
        check_chunk_exactness(ctx, inst, m, n, chunks)
        try:
            plan = scheme.plan(m, n, None if scheme.fixed_workers else N,
                               seed=0)
        except ValueError:
            continue  # no one-row-per-device SPMD plan (e.g. mds): host-only
        except RuntimeError as exc:
            ctx.add("plan-construction",
                    f"(m={m}, n={n}, N={N}) device plan construction failed: "
                    f"{exc}")
            continue
        check_plan_decode(ctx, plan, m, n, trials, rng)
        check_pack_consistency(ctx, plan, m, n, rng)
    return ctx.findings


def run_scheme_checks(*, configs=DEFAULT_CONFIGS, chunks=DEFAULT_CHUNKS,
                      trials: int = 20) -> tuple[list[Finding], int]:
    """Validate every scheme in the registry.  Returns
    (findings, schemes_checked)."""
    from repro_torch.coded.registry import scheme_names

    findings: list[Finding] = []
    count = 0
    for name in scheme_names():
        findings.extend(validate_scheme(
            name, configs=configs, chunks=chunks, trials=trials))
        count += 1
    return findings, count
