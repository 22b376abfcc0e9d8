"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Builds the CUDA kernels of ``src/repro_torch`` (nvcc, into ``build/``),
and prints the SpMM kernel's design (column blocks and columns a thread
block, its ring of staged B) with ptxas's registers and spills of each of
its instances.  It holds each kernel against its plain PyTorch version on
the card -- the SpMM kernels also at the edges of their design (a last
group of column blocks cut short, column blocks with no live slot, every
slot padded, one slot, disjoint row-blocks in a group, every slot on one B
tile, a ring that wraps with a ragged bt), each launched twice and held
bitwise equal -- then runs the
main path -- ``plan -> bind -> apply`` of a coded sparse product
C = A^T B -- at full size (s=16384, r=t=8192, m=n=2, N=8 workers, 8x8
tiles at 10% block density: the geometry of the repo's coded-matmul
benchmark, scaled up) and compares every C with the dense product.
Then it drives the kernel entry points ``ops.spmm_block`` (the uncoded
A^T B over the whole block-ELL of A) and ``ops.coded_accum`` (every
worker's dense coded accumulation, decoded) on the same operands and
compares both with the dense product too.  The ``coded_accum`` kernel
(3xTF32 on the tensor cores) is also held against its plain version at
shapes that fill whole 128 x 128 tiles and leave ragged edges, on both of
its copy paths, and its eight launches are timed as a whole beside the
port's cuBLAS dense scan.

Three phases drive the straggler runtime on the card.  ``device_job``
runs ``run_device_job`` on the main path's operands (block_sparse with
the caller's block-ELL, so the pack cache hits: all alive, a dead worker,
a worker that finished 2 of its 4 chunks; dense_scan all alive), and
holds ``coded_matmul`` and ``uncoded_matmul_reference`` to ``CodedOp``
and the dense product.  ``straggler_job`` runs ``run_coded_job`` at the
paper's square experiment (r = s = t = 150,000, nnz(A) = nnz(B) =
600,000, m = n = 4, sparse CSR f32 blocks, 28 workers, two of them 10x
slow) at q = 1 and 4, timing the hybrid decoder beside ``gaussian_decode``
on the same collected results, plus one dense run on the main path's
operands.  ``live_job`` runs ``run_live_job`` there with two workers
sleeping 2 s, and one ``JobMux(source="live")`` batch of three jobs.
``proc_job`` runs ``run_proc_job`` there: 28 worker processes, each with
a CUDA context of its own, in the live job's case, without a fault, and
with each fault class (kill, pause, slow, drop_result: each checked to
have fired and the job to decode, beside ``FaultRealization``'s
prediction), a respawn and an unrecoverable kill; ``proc_mux`` one
``JobMux`` batch over a ``MuxProcPool`` with worker 1 killed; ``schemes``
the port's scheme checks over the registry and on the main path's
full-size pack.  Worker processes re-import this script: nothing at its
module level touches the card.
Each phase prints one JSON line; the line before the last lists the
kernels with their launches, times and bounds, and the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is nonzero and no result line is printed.  It exits nonzero at once
where no CUDA device is present.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32 FLOP/s on
# the CUDA cores (the spmm_block kernels compute in IEEE f32 there), and
# TF32 FLOP/s on the tensor cores (coded_accum, three passes for f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
EPS32 = float(np.finfo(np.float32).eps)

# the full-size main path
S, R, T, BS = 16384, 8192, 8192, 8
M_BLK, N_BLK, WORKERS, DENSITY, SEED = 2, 2, 8, 0.10, 0
# end-to-end tolerance, relative to max|A^T B|: the coded sums accumulate
# over s in f32 (error ~ eps * sqrt(live terms) * |coded partial sums|,
# and coded partial sums run ~ |w| * degree = up to 64x the blocks they
# encode) and the decode D = pinv(M) amplifies that by at most cond(M);
# printed beside each result.  1e-3 leaves room for cond(M) ~ 100.
E2E_RTOL = 1e-3

# the paper's square experiment (Section V: random sparse A, B with
# integer entries 1..4), its sparse code over num_workers + 12 = 28
# workers with 2 of them 10x slow, as the JAX package's completion
# benchmark runs it
PAPER_DIM, PAPER_NNZ, PAPER_MN, PAPER_WORKERS = 150_000, 600_000, 4, 28
PAPER_SLOW, PAPER_SLOWDOWN, LIVE_SLEEP_S = 2, 10.0, 2.0
LIVE_SPIN_CYCLES = 10**9  # the card's spin before in-flight inputs are made (~0.5 s)
# the process runtime (phases proc_job, proc_mux) on the same operands:
# each worker's sleep over its q = 4 chunks -- a faulted worker's first
# chunk comes 0.05 s after go, the others' every 0.5 s, so no decodable
# prefix comes before the fault's trigger -- and a heartbeat deadline far
# past the job (the deadline is not what these cases exercise)
PROC_Q, PROC_SLEEP_S, PROC_FAULTED_SLEEP_S, PROC_DEADLINE_S = 4, 2.0, 0.2, 10.0
PROC_TIMEOUT_S = 300.0  # start-up (28 processes, each its own CUDA context) included
# decoded blocks against the true block products, relative to max|block|:
# the decode runs in f32 with code weights up to (mn)^2 = 256 and rooting
# coefficients from a float64 solve, so it rounds at ~eps * cond; the
# main path's limit
DECODE_RTOL = 1e-3


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median of ``reps`` timings of fn() with CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def sum_tol(K: int, scale: float) -> float:
    """Two f32 sums of K terms taken in different orders (the kernel's slot
    loop vs the plain version's einsum): allow 8 sqrt(K) eps of the
    largest output."""
    return 8.0 * math.sqrt(K) * EPS32 * max(scale, 1e-30)


# ------------------------------- phase 1 ------------------------------------

def phase_device() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "allow_tf32": False}
    emit(phase="device", **info)
    return info


# ------------------------------- phase 2 ------------------------------------

LIBRARIES = ("spmm_block", "coded_accum")


#: the template arguments of an spmm_block_fused_kernel instance, as the
#: Itanium ABI mangles them: <bs, tile type, DECODE, PLAIN>
_SPMM_INSTANCE = re.compile(
    r"spmm_block_fused_kernelILi(\d+)E(f|13__nv_bfloat16|a)Lb([01])ELb([01])E")
_TILE_TYPES = {"f": "float32", "13__nv_bfloat16": "bfloat16", "a": "int8"}


def spmm_instances(log: str) -> dict:
    """ptxas's registers and spills of each spmm_block kernel instance, by
    "bs=<bs> <tile type> <form>" (form: fused, fused_decode or plain)."""
    found, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = _SPMM_INSTANCE.search(entry.group(1))
            name = None
            if m:
                bs, tv, decode, plain = m.groups()
                form = "plain" if plain == "1" else (
                    "fused_decode" if decode == "1" else "fused")
                name = f"bs={bs} {_TILE_TYPES[tv]} {form}"
                found[name] = {}
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            found[name]["spill_bytes"] = int(spill.group(1)) + int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            found[name]["registers"] = int(used.group(1))
    return found


def _build_one(name: str) -> dict:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    path = build.build(name)
    build.load_library(name)
    log = build.BUILD_LOG.get(name, "")
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", log)]
    out = {"library": str(path.relative_to(ROOT)),
           "seconds": time.perf_counter() - t0,
           "ptxas": sorted({ln.split(":", 1)[1].strip() for ln in log.splitlines()
                            if "Used" in ln and "registers" in ln}),
           "max_spill_bytes": max(spills, default=0)}
    if name == "spmm_block":
        out["instances"] = spmm_instances(log)
        check(len(out["instances"]) == 18,
              f"spmm_block: {len(out['instances'])} kernel instances in ptxas's log")
    return out


def phase_build() -> dict:
    """Every library built at once, one nvcc each; the spmm_block kernel's
    design and its instances' registers and spills."""
    from repro_torch.kernels import spmm_block

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
        libs = dict(zip(LIBRARIES, pool.map(_build_one, LIBRARIES)))
    design = {f"bs={bs}": spmm_block.kernel_geometry(bs) for bs in (8, 16)}
    emit(phase="build", seconds=time.perf_counter() - t0, libraries=libs,
         spmm_block_design=design)
    return {"design": design, "instances": libs["spmm_block"]["instances"]}


# ------------------------------- phase 3 ------------------------------------

def _quantize(vals: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(vals)
    if dtype == "bfloat16":
        return t.to(torch.bfloat16)
    if dtype == "int8":
        return torch.from_numpy(np.clip(np.rint(vals * 40), -127, 127).astype(np.int8))
    return t


def _hold(name: str, vals, src, wsl, dvec, B, bt: int, t_tile: int = 128) -> dict:
    """Both kernels against their plain versions on the same CUDA tensors,
    the bitwise fused == dvec (x) two-step check, and a second launch of
    each equal to the first, bit for bit."""
    from repro_torch.kernels import ref, spmm_block

    def both():
        return (spmm_block.spmm_block_fused(vals, src, wsl, B, bt=bt, t_tile=t_tile),
                spmm_block.spmm_block_fused_decode(vals, src, wsl, dvec, B, bt=bt,
                                                   t_tile=t_tile))

    two, fused = both()
    two_again, fused_again = both()
    two_ref = ref.spmm_block_fused_ref(vals, src, wsl, B, bt)
    fused_ref = ref.spmm_block_fused_decode_ref(vals, src, wsl, dvec, B, bt)
    torch.cuda.synchronize()
    K = vals.shape[1] * vals.shape[2]
    err_two = float((two - two_ref).abs().max()) if two.numel() else 0.0
    err_fused = float((fused - fused_ref).abs().max()) if fused.numel() else 0.0
    tol_two = sum_tol(K, float(two_ref.abs().max()) if two.numel() else 0.0)
    tol_fused = sum_tol(K, float(fused_ref.abs().max()) if fused.numel() else 0.0)
    bitwise = bool(torch.equal(fused, dvec[:, None, None] * two[None]))
    again = bool(torch.equal(two, two_again) and torch.equal(fused, fused_again))
    out = {"case": name, "copy_path": spmm_block.copy_path(B),
           "err_fused": err_two, "tol_fused": tol_two,
           "err_fused_decode": err_fused, "tol_fused_decode": tol_fused,
           "bitwise_fused_decode_eq_dvec_x_two_step": bitwise,
           "bitwise_second_launch": again}
    check(err_two <= tol_two, f"{name}: two-step kernel vs plain {err_two} > {tol_two}")
    check(err_fused <= tol_fused, f"{name}: fused-decode kernel vs plain {err_fused} > {tol_fused}")
    check(bitwise, f"{name}: fused decode != dvec * two-step, bitwise")
    check(again, f"{name}: a second launch differs from the first")
    return out


def _edge_case(rng, bs: int, G: int, kind: str):
    """Operands (numpy) at one edge of the kernel's design: vals, src, w,
    B, bt.  Column blocks come in groups of G per thread block; B's keys
    (row-block, column group) in chunks of the ring."""
    n, bt, s, CB, L = 2, 40, 64 * bs, G + 3, 6
    if kind == "CB below G":
        CB = max(1, G // 2 - 1)
    if kind == "L = 1":
        L = 1
    if kind == "ring wraps, ragged bt, 4-byte copies":
        n, bt, s, L = 3, 251, 256 * bs, 24
    vals = rng.standard_normal((CB, L, bs, bs)).astype(np.float32)
    src = np.stack([rng.integers(0, s // bs, (CB, L)),
                    rng.integers(0, n, (CB, L))], -1).astype(np.int32)
    w = rng.standard_normal((CB, L)).astype(np.float32)
    w[rng.random((CB, L)) < 0.2] = 0.0                   # pads among the slots
    if kind == "column blocks with no live slot":
        w[::3] = 0.0
    if kind == "all slots padded":
        w[:] = 0.0
    if kind == "disjoint row-blocks in a group":
        per = (s // bs) // CB                            # cb reads its own rows
        src[..., 0] = np.arange(CB)[:, None] * per + rng.integers(0, per, (CB, L))
    if kind == "one B tile for every slot":
        src[..., 0], src[..., 1] = 5, 1
    B = rng.standard_normal((s, n * bt)).astype(np.float32)
    return vals, src, w, B, bt


EDGE_KINDS = ("CB no multiple of G", "CB below G", "column blocks with no live slot",
              "all slots padded", "L = 1", "disjoint row-blocks in a group",
              "one B tile for every slot", "ring wraps, ragged bt, 4-byte copies")


def phase_kernels() -> None:
    """Kernel vs plain at the tests' shapes, then at one mid-sized pack."""
    from repro_torch.coded import CodedMatmulConfig, plan
    from repro_torch.core.coded_matmul import DeviceTilePack, _block_sparse_operands
    from repro_torch.sparse import dense_to_block_ell

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    cases = []
    for bs in (8, 16):
        for bt, t_tile in ((128, 128), (24, 24), (40, 8), (251, 128)):
            for dtype in ("float32", "bfloat16", "int8"):
                CB, L, s, n, mn = 4, 5, 64, 3, 4
                vals = rng.standard_normal((CB, L, bs, bs)).astype(np.float32)
                src = np.stack([rng.integers(0, s // bs, (CB, L)),
                                rng.integers(0, n, (CB, L))], -1).astype(np.int32)
                w = rng.standard_normal((CB, L)).astype(np.float32)
                w[:, -1] = 0.0                     # a padded slot
                B = rng.standard_normal((s, n * bt)).astype(np.float32)
                dvec = rng.standard_normal(mn).astype(np.float32)
                cases.append(_hold(
                    f"bs={bs} bt={bt} t_tile={t_tile} {dtype}",
                    _quantize(vals, dtype).to(dev), torch.from_numpy(src).to(dev),
                    torch.from_numpy(w).to(dev), torch.from_numpy(dvec).to(dev),
                    torch.from_numpy(B).to(dev), bt, t_tile))
    emit(phase="kernel_vs_plain", shapes="tests", cases=cases)

    # mid-sized: a real pack, s=2048, br=bt=512, 10% blocks, worker 0
    s, r, t = 2048, 1024, 1024
    mask = rng.random((s // BS, r // BS)) < DENSITY
    A = (rng.standard_normal((s // BS, BS, r // BS, BS), dtype=np.float32)
         * mask[:, None, :, None]).reshape(s, r)
    B = torch.from_numpy(rng.standard_normal((s, t), dtype=np.float32)).to(dev)
    ell = dense_to_block_ell(A, BS)
    cases = []
    for dtype in ("float32", "bfloat16", "int8"):
        op = plan(CodedMatmulConfig(backend="block_sparse", compute_dtype=dtype),
                  M_BLK, N_BLK, WORKERS, seed=SEED)
        dpack = DeviceTilePack.from_pack(op.pack_for(ell, use_cache=False), dev)
        wsl = _block_sparse_operands(op.base_plan, dpack)
        dvec = torch.from_numpy(op.base_plan.decode[:, 0].copy()).to(dev)
        cases.append(_hold(f"s={s} br=bt=512 worker 0 {dtype}", dpack.vals[0],
                           dpack.src[0], wsl[0], dvec, B, t // N_BLK))
    emit(phase="kernel_vs_plain", shapes="mid", cases=cases)
    phase_edges(dev, rng)


def phase_edges(dev, rng) -> None:
    """The kernel at the edges of its design, bs 8 and 16: column blocks
    that do not fill the last group, column blocks with no live slot, every
    slot padded, one slot, a group whose column blocks read disjoint rows,
    every slot on one B tile, and a ring that wraps with a ragged bt copied
    4 bytes at a time."""
    from repro_torch.kernels import spmm_block

    cases = []
    for bs in (8, 16):
        G = spmm_block.kernel_geometry(bs)["G"]
        for kind in EDGE_KINDS:
            dtype = ("float32", "bfloat16", "int8")[len(cases) % 3]
            vals, src, w, B, bt = _edge_case(rng, bs, G, kind)
            dvec = rng.standard_normal(4).astype(np.float32)
            args = (_quantize(vals, dtype).to(dev), torch.from_numpy(src).to(dev),
                    torch.from_numpy(w).to(dev), torch.from_numpy(dvec).to(dev),
                    torch.from_numpy(B).to(dev), bt)
            cases.append(_hold(f"bs={bs} G={G} CB={vals.shape[0]} "
                               f"L={vals.shape[1]} {kind} {dtype}", *args))
            if kind == "all slots padded":
                two = spmm_block.spmm_block_fused(*args[:3], args[4], bt=bt)
                check(not bool(two.any()), f"bs={bs} {kind}: output not all zero")
    emit(phase="kernel_vs_plain", shapes="edges", cases=cases)


def _held(name: str, got: torch.Tensor, want: torch.Tensor, K: int) -> dict:
    """One kernel result against its plain version, within sum_tol(K)."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    tol = sum_tol(K, float(want.abs().max()) if want.numel() else 0.0)
    check(tuple(got.shape) == tuple(want.shape), f"{name}: shape {tuple(got.shape)}")
    check(err <= tol, f"{name}: kernel vs plain {err} > {tol}")
    return {"case": name, "err": err, "tol": tol}


def phase_entry_kernels() -> None:
    """The plain block-ELL and dense coded-accumulation kernels against their
    plain versions at the JAX package's kernel-test shapes, f32 and bf16."""
    from repro_torch.kernels import coded_accum, ref, spmm_block
    from repro_torch.sparse import dense_to_block_ell

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for m, n, s, r, t, L in ((2, 2, 128, 16, 24, 3), (2, 2, 256, 32, 32, 5),
                                 (4, 2, 128, 32, 16, 7), (1, 4, 128, 8, 32, 2),
                                 (3, 3, 384, 24, 36, 4)):
            A = torch.from_numpy(rng.standard_normal((s, r), dtype=np.float32))
            B = torch.from_numpy(rng.standard_normal((s, t), dtype=np.float32))
            cols = torch.from_numpy(rng.integers(0, m * n, L).astype(np.int32))
            w = rng.standard_normal(L).astype(np.float32)
            w[-1] = 0.0                                  # a padded slot
            A, B, cols, w = (A.to(dev, dtype), B.to(dev, dtype), cols.to(dev),
                             torch.from_numpy(w).to(dev))
            cases.append({**_held(
                f"coded_accum m={m} n={n} s={s} r={r} t={t} L={L} {dtype}",
                coded_accum.coded_accum(A, B, cols, w, m=m, n=n),
                ref.coded_accum_ref(A, B, cols, w, m, n), s * L),
                "copy_path": coded_accum.copy_path(dtype, dtype, r, t, r // m, t // n,
                                                   A.data_ptr(), B.data_ptr())})
        for bs, RB, CB, t, density in ((8, 4, 4, 128, 0.3), (8, 8, 2, 256, 0.1),
                                       (16, 4, 4, 128, 0.5), (8, 2, 8, 128, 0.9)):
            mask = rng.random((RB, CB)) < density
            A = (rng.standard_normal((RB * bs, CB * bs)).astype(np.float32)
                 * np.kron(mask, np.ones((bs, bs), np.float32)))
            ell = dense_to_block_ell(A, bs)
            vals = torch.from_numpy(ell.vals).to(dev, dtype)
            idx = torch.from_numpy(ell.idx).to(dev)
            B = torch.from_numpy(rng.standard_normal((RB * bs, t), dtype=np.float32)
                                 ).to(dev, dtype)
            cases.append(_held(
                f"spmm_block bs={bs} RB={RB} CB={CB} t={t} {dtype}",
                spmm_block.spmm_block(vals, idx, B),
                ref.spmm_block_ref(vals, idx, B), vals.shape[1] * bs))
    emit(phase="kernel_vs_plain", shapes="tests", kernels=["coded_accum", "spmm_block"],
         cases=cases)


#: (m, n, s, br, bt, L, live) of the tile cases: whole 128 x 128 tiles with
#: ragged edges and an s that is no multiple of the kernel's 32-row chunk
#: (16-byte copies), the same with br, bt that no 16-byte copy divides (one
#: element a copy), an aligned case, and a task table of pads only
ACCUM_TILE_SHAPES = ((2, 2, 1060, 200, 136, 4, 3), (2, 2, 1060, 201, 133, 4, 3),
                     (2, 2, 2048, 384, 384, 4, 3), (2, 2, 256, 200, 136, 2, 0))


def phase_accum_tiles() -> None:
    """coded_accum against its plain version where its MMA tiles fill and
    its edges are ragged, in f32, bf16 and mixed operands, on both copy
    paths, with a padded slot in every table."""
    from repro_torch.kernels import coded_accum, ref

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 1)
    f32, bf16 = torch.float32, torch.bfloat16
    cases, paths = [], {}
    for da, db in ((f32, f32), (bf16, bf16), (f32, bf16), (bf16, f32)):
        for m, n, s, br, bt, L, live in ACCUM_TILE_SHAPES:
            A = torch.from_numpy(rng.standard_normal((s, m * br), dtype=np.float32))
            B = torch.from_numpy(rng.standard_normal((s, n * bt), dtype=np.float32))
            cols = torch.from_numpy(rng.integers(0, m * n, L).astype(np.int32))
            w = rng.standard_normal(L).astype(np.float32)
            w[live:] = 0.0                               # padded slots
            A, B, cols, w = (A.to(dev, da), B.to(dev, db), cols.to(dev),
                             torch.from_numpy(w).to(dev))
            path = coded_accum.copy_path(da, db, m * br, n * bt, br, bt,
                                         A.data_ptr(), B.data_ptr())
            paths.setdefault((da, db), set()).add(path)
            cases.append({**_held(
                f"coded_accum m={m} n={n} s={s} br={br} bt={bt} L={L} live={live} "
                f"{da} x {db}", coded_accum.coded_accum(A, B, cols, w, m=m, n=n),
                ref.coded_accum_ref(A, B, cols, w, m, n), s * L), "copy_path": path})
    for pair, seen in paths.items():
        check(seen == {"wide", "narrow"}, f"coded_accum {pair}: copy paths {seen}")
    emit(phase="kernel_vs_plain", shapes="tiles", kernels=["coded_accum"], cases=cases)


# ------------------------------- phase 4 ------------------------------------

@contextlib.contextmanager
def two_step_decode():
    """block_sparse with its decode epilogue switched off: the local product
    kernel, then dvec * C~ in PyTorch -- the two-step form the JAX
    package's spmd check toggles the same way."""
    from repro_torch.core import coded_backends

    entry = coded_backends.get_backend("block_sparse")
    entry.fused_decode = False
    try:
        yield
    finally:
        entry.fused_decode = True


def _bound(nbytes: int, flops: int, rate: float = F32_FLOP_PER_S,
           passes: int = 1) -> dict:
    """The larger of bytes over the HBM rate and ``passes`` times the FLOPs
    over ``rate`` (by default the f32 CUDA cores' peak), in ms, on the H100
    SXM data sheet."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = passes * flops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def launch_bound(pack, wsl, k: int, bt: int, mn: int, decode: bool) -> dict:
    """The least time the card could take for worker k's launch: each input
    read once (the live slots' tiles, addresses and weights, each distinct B
    tile), each output written once, against the f32 FLOPs of the live
    slots, on the H100 SXM peaks."""
    live = wsl[k] != 0
    n_live = int(live.sum())
    src = pack.src[k][live].long()
    n_groups = int(src[:, 1].max()) + 1 if n_live else 1
    distinct_b = int(torch.unique(src[:, 0] * n_groups + src[:, 1]).numel())
    CB, _, bs, _ = pack.vals[k].shape
    out_copies = mn if decode else 1
    nbytes = (n_live * (bs * bs * pack.vals.element_size() + 3 * 4)
              + distinct_b * bs * bt * 4 + out_copies * CB * bs * bt * 4
              + (mn * 4 if decode else 0))
    flops = n_live * 2 * bs * bs * bt + (mn * CB * bs * bt if decode else 0)
    return {**_bound(nbytes, flops), "live_slots": n_live}


def _bsr(rows: torch.Tensor, cols: torch.Tensor, tiles: torch.Tensor,
         size: tuple[int, int]) -> torch.Tensor:
    """A BSR matrix from (block row, block column, tile) triples, tiles of
    a repeated block summed: the yardstick's operand, built once."""
    n_cols = size[1] // tiles.shape[-1]
    keys, inv = torch.unique(rows.long() * n_cols + cols.long(), return_inverse=True)
    summed = torch.zeros((keys.numel(),) + tuple(tiles.shape[1:]),
                         dtype=torch.float32, device=tiles.device)
    summed.index_add_(0, inv, tiles.float())
    n_rows = size[0] // tiles.shape[-2]
    crow = torch.zeros(n_rows + 1, dtype=torch.int64, device=tiles.device)
    crow[1:] = torch.cumsum(torch.bincount(keys // n_cols, minlength=n_rows), 0)
    return torch.sparse_bsr_tensor(crow, keys % n_cols, summed, size=size,
                                   check_invariants=True)


def yardstick(candidates: dict, want: torch.Tensor) -> dict:
    """The first of ``candidates`` (a name -> a builder of a zero-argument
    PyTorch call, its operands built outside the timed region) that the
    card's torch runs: its time and max error against the kernel's result.
    A refusal (an unsupported layout, too little memory) is printed and kept
    by name.  A yardstick, never the path."""
    refused = {}
    for name, build_call in candidates.items():
        try:
            call = build_call()
            got = call()
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as exc:
            print(f"chip_smoke: yardstick {name} refused: {exc}", flush=True)
            refused[name] = str(exc).splitlines()[0][:160]
            torch.cuda.empty_cache()
            continue
        err = float((got - want).abs().max())
        del got
        return {"library_ms": time_ms(call), "library": name,
                "library_max_abs_err": err, "library_refused": refused}
    return {"library_ms": None, "library": None, "library_max_abs_err": None,
            "library_refused": refused}


def sparse_candidates(make_bsr, dense_b: torch.Tensor) -> dict:
    """One sparse product of the same matrix with B: as BSR, then as CSR
    (the card's torch may gather a (blocks, bs, t) copy of B for small BSR
    blocks, which does not fit at full width)."""
    def bsr_call():
        A_s = make_bsr()
        return lambda: A_s @ dense_b

    def csr_call():
        A_s = make_bsr().to_dense().to_sparse_csr()
        return lambda: A_s @ dense_b

    return {"torch.sparse_bsr_tensor @ B": bsr_call,
            "torch.sparse_csr_tensor @ B": csr_call}


def phase_main(built: dict) -> tuple[list[dict], dict]:
    """The main path at full size; its kernels' rows, and the operands the
    entry-point phase reuses."""
    from repro_torch.coded import CodedMatmulConfig, from_plan, plan
    from repro_torch.core.coded_matmul import _block_sparse_operands
    from repro_torch.core.decoder import DecodingError
    from repro_torch.kernels import ref, spmm_block
    from repro_torch.runtime import pack_cache
    from repro_torch.sparse import dense_to_block_ell

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    mask = rng.random((S // BS, R // BS)) < DENSITY
    A_np = (rng.standard_normal((S // BS, BS, R // BS, BS), dtype=np.float32)
            * mask[:, None, :, None]).reshape(S, R)
    B = torch.from_numpy(rng.standard_normal((S, T), dtype=np.float32)).to(dev)
    A = torch.from_numpy(A_np).to(dev)
    ell = dense_to_block_ell(A_np, BS)
    data_s = time.perf_counter() - t0

    cfg = CodedMatmulConfig(scheme="sparse_code", backend="block_sparse",
                            block_size=BS)
    op = plan(cfg, m=M_BLK, n=N_BLK, num_workers=WORKERS, seed=SEED).bind()
    op_sh = from_plan(dataclasses.replace(cfg, out_sharded=True),
                      op.base_plan).bind()
    dead = None
    for k in [3] + [j for j in range(WORKERS) if j != 3]:
        surv = np.ones(WORKERS, dtype=bool)
        surv[k] = False
        try:
            op_dead = op.with_survivors(surv)
        except DecodingError:
            continue
        dead = k
        break
    check(dead is not None, "no single dead worker leaves a decodable plan")

    pack_ms = statistics.median(
        _host_ms(lambda: op.pack_for(ell, use_cache=False)) for _ in range(3))
    ref_C = A.T @ B
    torch.cuda.synchronize()
    scale = float(ref_C.abs().max())

    variants = [("all alive, replicated", op),
                (f"worker {dead} dead, replicated", op_dead),
                ("all alive, out_sharded", op_sh),
                (f"worker {dead} dead, out_sharded",
                 op_sh.with_survivors(op_dead.survivors))]
    L = spmm_block.LAUNCHES
    t0 = time.perf_counter()
    # ---- the main path: counts from 0, one apply per variant, counts read
    spmm_block.reset_launch_counts()
    results = []
    for name, v in variants:
        before = dict(L)
        C = v(A, B, a_sparse=ell)
        torch.cuda.synchronize()
        results.append((name, v, C, {k: L[k] - before[k] for k in L}))
    with two_step_decode():
        before = dict(L)
        C_two = op(A, B, a_sparse=ell)
        torch.cuda.synchronize()
        two_launches = {k: L[k] - before[k] for k in L}
    main_launches = dict(L)
    # ---------------------------------------------------------------------
    first_pass_s = time.perf_counter() - t0

    rows = []
    for name, v, C, launches in results:
        err = float((C - ref_C).abs().max())
        M_eff = v.plan_.coefficient_matrix()
        if v.survivors is not None:
            M_eff = M_eff[v.survivors]
        rows.append({"variant": name, "shape": list(C.shape),
                     "finite": bool(torch.isfinite(C).all()),
                     "rel_err": err / scale, "rtol": E2E_RTOL,
                     "cond_M": float(np.linalg.cond(M_eff[M_eff.any(axis=1)])),
                     "launches": launches})
        check(tuple(C.shape) == (R, T), f"{name}: C shape {tuple(C.shape)}")
        check(rows[-1]["finite"], f"{name}: non-finite C")
        check(err / scale <= E2E_RTOL, f"{name}: rel err {err / scale} > {E2E_RTOL}")
        check(launches["spmm_block_fused_decode"] == WORKERS
              and launches["spmm_block_fused"] == 0,
              f"{name}: launches {launches}, want {WORKERS} fused-decode")
    check(two_launches["spmm_block_fused"] == WORKERS
          and two_launches["spmm_block_fused_decode"] == 0,
          f"two-step apply launches {two_launches}")
    two_equal = bool(torch.equal(C_two, results[0][2]))
    check(two_equal, "two-step C != fused-decode C, bitwise")
    emit(phase="main_path", S=S, R=R, T=T, m=M_BLK, n=N_BLK, workers=WORKERS,
         block_size=BS, block_density=float(mask.mean()),
         live_tile_fraction=ell.density(), max_degree=op.base_plan.max_degree,
         dead_worker=dead, variants=rows,
         two_step={"launches": two_launches, "bitwise_eq_fused": two_equal},
         launches=main_launches, data_setup_s=data_s,
         first_pass_s=first_pass_s)

    # ---- times (after the counts were read) ----
    apply_ms = {name: time_ms(lambda v=v: v(A, B, a_sparse=ell))
                for name, v, _, _ in results}
    dense_ms = time_ms(lambda: A.T @ B)
    emit(phase="times", unit="ms", host_pack_ms=pack_ms, apply_ms=apply_ms,
         library_dense_matmul_ms=dense_ms,
         peak_device_bytes=torch.cuda.max_memory_allocated())
    emit(phase="profile", variant=results[0][0],
         **profile_apply(lambda: op(A, B, a_sparse=ell)))

    # ---- each kernel at the main path's shape: the heaviest worker ----
    wp = op.pack_for(ell)
    dpack = pack_cache.device_pack(wp, dev)
    wsl = _block_sparse_operands(op.base_plan, dpack)
    k = int(np.argmax(wp.live_tiles))
    bt = T // N_BLK
    mn = M_BLK * N_BLK
    dvec = torch.from_numpy(op.base_plan.decode[:, k].copy()).to(dev)
    args = (dpack.vals[k], dpack.src[k], wsl[k])
    K = dpack.vals.shape[2] * BS

    # yardstick of both: the worker's product as one sparse @ B with its
    # column groups stacked, the slot weights (and int8 scales) folded into
    # the tiles, all built once
    live = wsl[k] != 0
    CBk, Lk = live.shape
    cb_of = torch.arange(CBk, device=dev)[:, None].expand(CBk, Lk)[live]
    src_live = dpack.src[k][live].long()
    tiles = (dpack.vals[k][live].float() * wsl[k][live][:, None, None]).transpose(1, 2)

    B_st = B.reshape(S, N_BLK, bt).permute(1, 0, 2).reshape(N_BLK * S, bt)
    two = spmm_block.spmm_block_fused(*args, B, bt=bt)
    lib = yardstick(sparse_candidates(
        lambda: _bsr(cb_of, src_live[:, 1] * (S // BS) + src_live[:, 0], tiles,
                     (CBk * BS, N_BLK * S)), B_st), two)
    lib_tol = sum_tol(K, float(two.abs().max()))
    del two, tiles, B_st
    torch.cuda.empty_cache()
    check(lib["library_ms"] is None or lib["library_max_abs_err"] <= lib_tol,
          f"yardstick disagrees with the kernel: {lib} > {lib_tol}")
    kernels = []
    for name, line, decode in (("spmm_block_fused_decode", 314, True),
                               ("spmm_block_fused", 176, False)):
        if decode:
            run = lambda: spmm_block.spmm_block_fused_decode(*args, dvec, B, bt=bt)
            plain = lambda: ref.spmm_block_fused_decode_ref(*args, dvec, B, bt)
        else:
            run = lambda: spmm_block.spmm_block_fused(*args, B, bt=bt)
            plain = lambda: ref.spmm_block_fused_ref(*args, B, bt)
        got, want = run(), plain()
        err = float((got - want).abs().max())
        tol = sum_tol(K, float(want.abs().max()))
        del want
        again = bool(torch.equal(got, run()))
        del got
        check(err <= tol, f"{name} at the main-path shape: {err} > {tol}")
        check(again, f"{name} at the main-path shape: a second launch differs")
        bound = launch_bound(dpack, wsl, k, bt, mn, decode)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spmm_block.cu",
            "replaces": f"src/repro/kernels/spmm_block.py:{line}",
            "launches": main_launches[name], "max_abs_err": err, "tol": tol,
            "bitwise_second_launch": again,
            "ms": time_ms(run), "plain_ms": time_ms(plain, reps=3),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            **lib, "library_operands": "the worker's weighted tiles, B's n "
            "column groups stacked",
            "design": built["design"][f"bs={BS}"],
            "copy_path": spmm_block.copy_path(B),
            "ptxas": built["instances"][
                f"bs={BS} float32 {'fused_decode' if decode else 'fused'}"],
            "shape": {"worker": k, "CB": int(dpack.vals.shape[1]),
                      "L": int(dpack.vals.shape[2]), "bs": BS, "bt": bt,
                      "mn": mn if decode else None,
                      "live_slots": bound["live_slots"],
                      "bytes": bound["bytes"], "flops": bound["flops"]}})
        torch.cuda.empty_cache()
    return kernels, {"A": A, "B": B, "ell": ell, "plan": op.base_plan,
                     "ref_C": ref_C, "dead": dead}


# ------------------------------- phase 5 ------------------------------------

def phase_entry_full(full: dict, built: dict) -> list[dict]:
    """The kernel entry points at the main path's width, on its operands:
    ``ops.spmm_block`` over the whole block-ELL of A (the uncoded A^T B, one
    launch) and ``ops.coded_accum`` for every worker of the main plan (one
    launch each).  Each is driven with the counts at 0 and read right after."""
    from repro_torch.core.coded_matmul import _local_dense_scan
    from repro_torch.kernels import coded_accum, ops, ref, spmm_block

    dev = torch.device("cuda", 0)
    A, B, ell, pl, ref_C = (full[x] for x in ("A", "B", "ell", "plan", "ref_C"))
    scale = float(ref_C.abs().max())
    vals = torch.from_numpy(ell.vals).to(dev)
    idx = torch.from_numpy(ell.idx).to(dev)
    cols = torch.from_numpy(pl.cols.astype(np.int32)).to(dev)
    wts = torch.from_numpy(pl.weights.astype(np.float32)).to(dev)
    D = torch.from_numpy(pl.decode).to(dev)
    br, bt = R // M_BLK, T // N_BLK

    def reset():
        spmm_block.reset_launch_counts()
        coded_accum.reset_launch_counts()

    def counts():
        return {**spmm_block.LAUNCHES, **coded_accum.LAUNCHES}

    # ---- the uncoded A^T B: counts from 0, one call, counts read
    reset()
    C5 = ops.spmm_block(vals, idx, B)
    torch.cuda.synchronize()
    launches5 = counts()
    # ---- every worker's dense coded accumulation: counts from 0, read
    reset()
    C_tilde = [ops.coded_accum(A, B, cols[k], wts[k], m=M_BLK, n=N_BLK)
               for k in range(WORKERS)]
    torch.cuda.synchronize()
    launches6 = counts()
    # ---------------------------------------------------------------------

    check(launches5["spmm_block"] == 1 and sum(launches5.values()) == 1,
          f"uncoded A^T B launches {launches5}, want 1 spmm_block")
    check(launches6["coded_accum"] == WORKERS
          and sum(launches6.values()) == WORKERS,
          f"coded accumulation launches {launches6}, want {WORKERS} coded_accum")
    check(tuple(C5.shape) == (R, T) and bool(torch.isfinite(C5).all()),
          f"spmm_block C: shape {tuple(C5.shape)} or non-finite")
    rel5 = float((C5 - ref_C).abs().max()) / scale
    check(rel5 <= E2E_RTOL, f"spmm_block C: rel err {rel5} > {E2E_RTOL}")
    # decode as the staged path does: blocks = sum_k D[:, k] (x) C~_k
    blocks = torch.stack([D[:, k, None, None] * C_tilde[k]
                          for k in range(WORKERS)]).sum(dim=0)
    C6 = blocks.reshape(M_BLK, N_BLK, br, bt).permute(0, 2, 1, 3).reshape(R, T)
    del blocks
    check(bool(torch.isfinite(C6).all()), "decoded coded_accum C: non-finite")
    rel6 = float((C6 - ref_C).abs().max()) / scale
    del C6
    check(rel6 <= E2E_RTOL, f"decoded coded_accum C: rel err {rel6} > {E2E_RTOL}")
    live_slots = (pl.weights != 0).sum(axis=1)
    emit(phase="entry_points", S=S, R=R, T=T, m=M_BLK, n=N_BLK,
         spmm_block={"rel_err": rel5, "rtol": E2E_RTOL, "launches": launches5},
         coded_accum={"rel_err_decoded": rel6, "rtol": E2E_RTOL,
                      "launches": launches6,
                      "live_slots_per_worker": live_slots.tolist()})

    kernels = []
    # ---- row 5 at its launch: kernel vs plain, times, bound, yardstick
    run5 = lambda: spmm_block.spmm_block(vals, idx, B)
    plain5 = lambda: ref.spmm_block_ref(vals, idx, B)
    row5 = _held("spmm_block, full width", C5, plain5(), ell.vals.shape[1] * BS)
    again5 = bool(torch.equal(C5, run5()))
    check(again5, "spmm_block at full width: a second launch differs")
    live = torch.arange(vals.shape[1], device=dev)[None, :] < torch.from_numpy(
        ell.nnzb).to(dev)[:, None]
    n_live = int(live.sum())
    n_rb = int(torch.unique(idx[live]).numel())
    bound5 = _bound(n_live * (BS * BS * 4 + 4) + n_rb * BS * T * 4 + R * T * 4,
                    n_live * 2 * BS * BS * T)
    cb_of = torch.arange(vals.shape[0], device=dev)[:, None].expand(live.shape)[live]
    tiles = vals[live].transpose(1, 2)
    lib5 = yardstick(sparse_candidates(
        lambda: _bsr(cb_of, idx[live], tiles, (R, S)), B), C5)
    del tiles, C5
    torch.cuda.empty_cache()
    check(lib5["library_ms"] is None or lib5["library_max_abs_err"] <= row5["tol"],
          f"yardstick disagrees with spmm_block: {lib5} > {row5['tol']}")
    kernels.append({
        "name": "spmm_block", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spmm_block.cu",
        "replaces": "src/repro/kernels/spmm_block.py:95",
        "launches": launches5["spmm_block"], "max_abs_err": row5["err"],
        "tol": row5["tol"], "bitwise_second_launch": again5,
        "ms": time_ms(run5), "plain_ms": time_ms(plain5, reps=3),
        "bound_ms": bound5["bound_ms"], "bound_by": bound5["bound_by"],
        **lib5, "library_operands": "A^T from the block-ELL",
        "design": built["design"][f"bs={BS}"],
        "copy_path": spmm_block.copy_path(B),
        "ptxas": built["instances"][f"bs={BS} float32 plain"],
        "shape": {"CB": int(vals.shape[0]), "L": int(vals.shape[1]), "bs": BS,
                  "t": T, "live_tiles": n_live, "bytes": bound5["bytes"],
                  "flops": bound5["flops"]}})
    torch.cuda.empty_cache()

    # ---- row 6 at its heaviest launch
    k = int(np.argmax(live_slots))
    args6 = (A, B, cols[k], wts[k])
    run6 = lambda: coded_accum.coded_accum(*args6, m=M_BLK, n=N_BLK)
    plain6 = lambda: ref.coded_accum_ref(*args6, M_BLK, N_BLK)
    row6 = _held(f"coded_accum worker {k}, full width", C_tilde[k], plain6(),
                 S * pl.cols.shape[1])
    slot_live = pl.weights[k] != 0
    blk = pl.cols[k][slot_live]
    n_i, n_j = len(set((blk // N_BLK).tolist())), len(set((blk % N_BLK).tolist()))
    nbytes6 = n_i * S * br * 4 + n_j * S * bt * 4 + br * bt * 4 + pl.cols.shape[1] * 8
    flops6 = int(slot_live.sum()) * 2 * S * br * bt
    # the kernel's tensor-core passes: 3xTF32 for f32 x f32 (A, B are f32 here)
    passes = 1 + (A.dtype == torch.float32) + (B.dtype == torch.float32)
    bound6 = _bound(nbytes6, flops6, TF32_FLOP_PER_S, passes)
    bound6_f32 = _bound(nbytes6, flops6)
    lib6 = lambda: _local_dense_scan(A, B, pl.cols[k], pl.weights[k], M_BLK, N_BLK)
    lib6_err = float((lib6() - C_tilde[k]).abs().max())
    check(lib6_err <= row6["tol"],
          f"dense-scan yardstick disagrees with coded_accum: {lib6_err} > {row6['tol']}")
    ms6 = time_ms(run6)
    # all eight workers' launches as a whole, beside the dense scan for all
    # eight (which also multiplies the pad slots, at weight 0)
    run_all = lambda: [coded_accum.coded_accum(A, B, cols[j], wts[j], m=M_BLK, n=N_BLK)
                       for j in range(WORKERS)]
    lib_all = lambda: [_local_dense_scan(A, B, pl.cols[j], pl.weights[j], M_BLK, N_BLK)
                       for j in range(WORKERS)]
    kernels.append({
        "name": "coded_accum", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/coded_accum.cu",
        "replaces": "src/repro/kernels/coded_accum.py:44",
        "launches": launches6["coded_accum"], "max_abs_err": row6["err"],
        "tol": row6["tol"], "ms": ms6, "plain_ms": time_ms(plain6, reps=3),
        "bound_ms": bound6["bound_ms"], "bound_by": bound6["bound_by"],
        "bound_rate": f"{passes}xTF32 on the tensor cores, {TF32_FLOP_PER_S:.3g} FLOP/s",
        "bound_f32_cores_ms": bound6_f32["bound_ms"],
        "tflops": flops6 / ms6 / 1e9,
        "copy_path": coded_accum.copy_path(A.dtype, B.dtype, R, T, br, bt,
                                           A.data_ptr(), B.data_ptr()),
        "library_ms": time_ms(lib6),
        "library": "the port's _local_dense_scan: L torch.matmul calls, TF32 off",
        "library_calls": int(pl.cols.shape[1]), "library_max_abs_err": lib6_err,
        "all_workers_ms": time_ms(run_all, reps=3),
        "library_all_workers_ms": time_ms(lib_all, reps=3),
        "all_workers_live_slots": int(live_slots.sum()),
        "library_all_workers_calls": int(pl.cols.size),
        "shape": {"worker": k, "s": S, "br": br, "bt": bt,
                  "L": int(pl.cols.shape[1]), "live_slots": int(slot_live.sum()),
                  "bytes": nbytes6, "flops": flops6}})
    return kernels


# ------------------------------- phase 6 ------------------------------------

def _effective_M(op) -> np.ndarray:
    M = op.plan_.coefficient_matrix()
    if op.survivors is not None:
        M = M[op.survivors]
    return M[M.any(axis=1)]


def phase_device_job(full: dict) -> dict:
    """``run_device_job`` at the main path's operands, block_sparse with the
    caller's block-ELL in three survivor cases and dense_scan once; its
    fused-decode launches counted from 0 in each case.  Then the legacy
    ``coded_matmul`` against ``CodedOp.apply`` (bit for bit) and
    ``uncoded_matmul_reference`` against the dense product."""
    from repro_torch import run_device_job
    from repro_torch.coded import CodedMatmulConfig, from_plan
    from repro_torch.core import coded_matmul
    from repro_torch.core.decoder import DecodingError
    from repro_torch.kernels import spmm_block
    from repro_torch.runtime import pack_cache

    A, B, ell, pl, ref_C = (full[x] for x in ("A", "B", "ell", "plan", "ref_C"))
    scale = float(ref_C.abs().max())
    op = from_plan(CodedMatmulConfig(backend="block_sparse", block_size=BS), pl).bind()
    chunks = None
    for k in [3] + [j for j in range(WORKERS) if j != 3]:
        mask = np.ones((WORKERS, 4), dtype=bool)
        mask[k, 2:] = False
        try:
            op.with_survivors(mask)
        except DecodingError:
            continue
        chunks = (k, mask)
        break
    check(chunks is not None, "no worker with 2 of 4 chunks leaves a decodable plan")
    dead = np.ones(WORKERS, dtype=bool)
    dead[full["dead"]] = False
    cases = [("block_sparse", "all alive", None),
             ("block_sparse", f"worker {full['dead']} dead", dead),
             ("block_sparse", f"worker {chunks[0]} finished 2 of 4 chunks", chunks[1]),
             ("dense_scan", "all alive", None)]
    L = spmm_block.LAUNCHES
    rows, total = [], {k: 0 for k in L}
    for backend, name, mask in cases:
        hits = pack_cache.cache_stats()["hits"]
        # ---- one path: counts from 0, one run_device_job, counts read
        spmm_block.reset_launch_counts()
        rep = run_device_job(A, B, pl, backend=backend, survivors=mask, repeats=3,
                             a_sparse=ell if backend == "block_sparse" else None)
        torch.cuda.synchronize()
        launches = dict(L)
        # ------------------------------------------------------------------
        for k in total:
            total[k] += launches[k]
        (C,) = rep.blocks
        rel = float((C - ref_C).abs().max()) / scale
        applies = 1 + 3  # the warm-up and the timed repeats
        want = ({"spmm_block_fused_decode": WORKERS * applies}
                if backend == "block_sparse" else {})
        rows.append({"backend": backend, "case": name,
                     "total_time_ms": rep.total_time * 1e3,
                     "workers_used": rep.workers_used, "rel_err": rel,
                     "rtol": E2E_RTOL,
                     "cond_M": float(np.linalg.cond(_effective_M(
                         op.with_survivors(mask) if mask is not None else op))),
                     "launches": launches,
                     "pack_cache_hits": pack_cache.cache_stats()["hits"] - hits})
        check(tuple(C.shape) == (R, T) and C.device.type == "cuda",
              f"device_job {backend} {name}: C {tuple(C.shape)} on {C.device}")
        check(bool(torch.isfinite(C).all()), f"device_job {backend} {name}: non-finite C")
        check(rel <= E2E_RTOL, f"device_job {backend} {name}: rel err {rel} > {E2E_RTOL}")
        check({k: v for k, v in launches.items() if v} == want,
              f"device_job {backend} {name}: launches {launches}, want {want}")
        check(backend == "dense_scan" or rows[-1]["pack_cache_hits"] > 0,
              f"device_job {backend} {name}: the pack cache did not hit")
        del C, rep
    # the legacy flat-argument entry and the plain product, after the counts
    C_op = op(A, B, a_sparse=ell)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        C_legacy = coded_matmul.coded_matmul(A, B, pl, backend="block_sparse",
                                             a_sparse=ell)
    legacy_equal = bool(torch.equal(C_legacy, C_op))
    check(any(issubclass(w.category, DeprecationWarning) for w in caught),
          "coded_matmul did not warn")
    check(legacy_equal, "coded_matmul C != CodedOp.apply C, bitwise")
    del C_op, C_legacy
    C_plain = coded_matmul.uncoded_matmul_reference(A, B)
    plain_rel = float((C_plain - ref_C).abs().max()) / scale
    del C_plain
    check(plain_rel <= E2E_RTOL, f"uncoded_matmul_reference rel err {plain_rel}")
    emit(phase="device_job", S=S, R=R, T=T, m=M_BLK, n=N_BLK, workers=WORKERS,
         repeats=3, cases=rows, launches=total,
         coded_matmul_bitwise_eq_coded_op=legacy_equal,
         uncoded_matmul_reference_rel_err=plain_rel)
    torch.cuda.empty_cache()
    return total


# ------------------------------- phase 7 ------------------------------------

def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|, on the values of a CSR difference (no
    block is made dense) or on dense blocks."""
    from repro_torch.core.blocks import is_csr

    if is_csr(want):
        check(is_csr(got), f"a decoded block of a sparse job is {got.layout}")
        diff = (got + want * -1.0).values()
        return float(diff.abs().max()) / float(want.values().abs().max())
    return float((got - want).abs().max()) / float(want.abs().max())


def _paper_operands(dev: torch.device) -> dict:
    """The paper's square A and B (integer entries 1..4 at uniformly random
    positions, repeated positions summed), split m = n = 4 on the host and
    moved to the card as CSR f32; A's blocks held transposed."""
    import scipy.sparse as sp

    from repro_torch.core.blocks import blocks_to_device, hold_a_blocks
    from repro_torch.core.encoder import compute_block_products, split_blocks

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()

    def bernoulli():
        X = sp.coo_matrix((rng.integers(1, 5, PAPER_NNZ).astype(np.float32),
                           (rng.integers(0, PAPER_DIM, PAPER_NNZ),
                            rng.integers(0, PAPER_DIM, PAPER_NNZ))),
                          shape=(PAPER_DIM, PAPER_DIM)).tocsr()
        X.sum_duplicates()
        return X

    A, B = bernoulli(), bernoulli()
    A_blocks = hold_a_blocks(split_blocks(A, PAPER_MN), dev)
    B_blocks = blocks_to_device(split_blocks(B, PAPER_MN), dev)
    prods = compute_block_products(A_blocks, B_blocks)
    truth = [prods[i][j] for i in range(PAPER_MN) for j in range(PAPER_MN)]
    torch.cuda.synchronize()
    return {"A": A_blocks, "B": B_blocks, "truth": truth,
            "nnz_A": int(A.nnz), "nnz_B": int(B.nnz),
            "nnz_C": int(sum(b._nnz() for b in truth)),
            "setup_s": time.perf_counter() - t0}


def _decode_times(code, truth, q: int, chunks_used: int) -> dict:
    """The hybrid decoder and ``gaussian_decode`` on the same collected
    results: the job's arrivals replayed with its seeded timeline, each
    decode's median of 3, ended at a synchronisation."""
    from repro_torch.core.decoder import gaussian_decode
    from repro_torch.runtime import SlowWorkers, executor

    chunked = code.chunked(q)
    times = SlowWorkers(PAPER_SLOW, PAPER_SLOWDOWN).chunk_completion_times(
        chunked.chunk_work(), np.random.default_rng(SEED))
    state = executor._consume_events(chunked,
                                     executor._sim_events(chunked, truth, times))
    check(len(state.pairs) == chunks_used, "replayed arrivals differ from the job's")
    rows = chunked.rows_of(state.pairs)
    data = [state.results_by_row[r] for r in rows]

    def median_ms(fn):
        out, ts = None, []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts), out

    hybrid_ms, _ = median_ms(lambda: chunked.decode(state.pairs, state.results_by_row))
    gauss_ms, gauss = median_ms(lambda: gaussian_decode(chunked.M[rows], data))
    return {"hybrid_ms": hybrid_ms, "gaussian_ms": gauss_ms,
            "gaussian_rel_err": max(_rel_err(g, w) for g, w in zip(gauss, truth))}


def phase_straggler_job(full: dict, dev: torch.device) -> dict:
    """``run_coded_job`` at the paper's square experiment, sparse CSR f32
    blocks on the card, q = 1 and 4; then one dense run on the main path's
    operands split m = n = 4."""
    from repro_torch.core import schemes
    from repro_torch.core.blocks import hold_a_blocks
    from repro_torch.core.encoder import compute_block_products, split_blocks
    from repro_torch.runtime import SlowWorkers, run_coded_job

    paper = _paper_operands(dev)
    code = schemes.sparse_code(PAPER_MN, PAPER_MN, PAPER_WORKERS, seed=SEED)
    dense_block_bytes = (PAPER_DIM // PAPER_MN) ** 2 * 4
    runs = []
    for q in (1, 4):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rep = run_coded_job(code, paper["truth"], SlowWorkers(PAPER_SLOW, PAPER_SLOWDOWN),
                            rng=np.random.default_rng(SEED), keep_blocks=True,
                            num_chunks=q)
        peak = torch.cuda.max_memory_allocated() - base
        layouts = sorted({str(b.layout) for b in rep.blocks})
        rel = max(_rel_err(g, w) for g, w in zip(rep.blocks, paper["truth"]))
        runs.append({"blocks": "sparse CSR f32", "q": q,
                     "sim_compute_time": rep.sim_compute_time,
                     "workers_used": rep.workers_used, "chunks_used": rep.chunks_used,
                     "decode_wall_time_ms": rep.decode_wall_time * 1e3,
                     "decode_stats": rep.decode_stats, "rel_err": rel,
                     "rtol": DECODE_RTOL, "layouts": layouts,
                     "peak_device_bytes_added": peak,
                     "dense_block_bytes": dense_block_bytes,
                     **_decode_times(code, paper["truth"], q, rep.chunks_used)})
        check(layouts == ["torch.sparse_csr"], f"straggler_job q={q}: layouts {layouts}")
        check(peak < dense_block_bytes,
              f"straggler_job q={q}: the job added {peak} B, one dense block's "
              f"{dense_block_bytes} B")
        check(rel <= DECODE_RTOL, f"straggler_job q={q}: rel err {rel} > {DECODE_RTOL}")
        check(runs[-1]["gaussian_rel_err"] <= DECODE_RTOL,
              f"straggler_job q={q}: gaussian rel err {runs[-1]['gaussian_rel_err']}")
        del rep

    # one dense run: the main path's A and B split m = n = 4
    A_blocks = hold_a_blocks(split_blocks(full["A"], PAPER_MN), dev)
    B_blocks = split_blocks(full["B"], PAPER_MN)
    prods = compute_block_products(A_blocks, B_blocks)
    truth = [prods[i][j] for i in range(PAPER_MN) for j in range(PAPER_MN)]
    del prods
    rep = run_coded_job(code, truth, SlowWorkers(PAPER_SLOW, PAPER_SLOWDOWN),
                        rng=np.random.default_rng(SEED), keep_blocks=True)
    rel = max(_rel_err(g, w) for g, w in zip(rep.blocks, truth))
    runs.append({"blocks": f"dense f32 {R // PAPER_MN}x{T // PAPER_MN}", "q": 1,
                 "sim_compute_time": rep.sim_compute_time,
                 "workers_used": rep.workers_used, "chunks_used": rep.chunks_used,
                 "decode_wall_time_ms": rep.decode_wall_time * 1e3,
                 "decode_stats": rep.decode_stats, "rel_err": rel, "rtol": DECODE_RTOL,
                 "layouts": sorted({str(b.layout) for b in rep.blocks}),
                 **_decode_times(code, truth, 1, rep.chunks_used)})
    check(rel <= DECODE_RTOL, f"straggler_job dense: rel err {rel} > {DECODE_RTOL}")
    del rep, truth, A_blocks, B_blocks
    torch.cuda.empty_cache()
    emit(phase="straggler_job", r=PAPER_DIM, s=PAPER_DIM, t=PAPER_DIM,
         nnz_A=paper["nnz_A"], nnz_B=paper["nnz_B"], nnz_C=paper["nnz_C"],
         m=PAPER_MN, n=PAPER_MN, workers=PAPER_WORKERS,
         straggler=f"SlowWorkers(num_slow={PAPER_SLOW}, slowdown={PAPER_SLOWDOWN})",
         setup_s=paper["setup_s"], runs=runs)
    return paper


# ------------------------------- phase 8 ------------------------------------

def _alive_workers(prefix: str) -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.name.startswith(prefix) and t.is_alive()]


def _in_flight(blocks: list) -> tuple[list, bool]:
    """Copies of sparse CSR blocks whose values are NaN until the card,
    after a spin of LIVE_SPIN_CYCLES on the current stream, copies the
    real ones in; nothing waits for that.  A job started now gets inputs
    the card has not finished, and a worker that reads them too early
    decodes NaN.  Returns the copies and whether they were still
    unfinished when this returned."""
    copies = [torch.sparse_csr_tensor(b.crow_indices(), b.col_indices(),
                                      torch.full_like(b.values(), float("nan")),
                                      b.shape, check_invariants=False)
              for b in blocks]
    torch.cuda.synchronize()
    torch.cuda._sleep(LIVE_SPIN_CYCLES)
    for c, b in zip(copies, blocks):
        c.values().copy_(b.values())
    done = torch.cuda.Event()
    done.record()
    return copies, not done.query()


def phase_live_job(paper: dict) -> None:
    """``run_live_job`` on the card at the paper's operands, two workers
    sleeping 2 s, q = 4: the job must decode before the sleepers finish;
    then one ``JobMux(source="live")`` batch of three jobs on one pool.
    Both are run once more on B blocks still being made when the job
    starts: the workers' streams must wait for them."""
    from repro_torch.core import schemes
    from repro_torch.runtime import JobMux, MuxJob, run_live_job

    A_blocks, B_blocks, truth = paper["A"], paper["B"], paper["truth"]
    code = schemes.sparse_code(PAPER_MN, PAPER_MN, PAPER_WORKERS, seed=SEED)
    sleepers = {0: LIVE_SLEEP_S, 1: LIVE_SLEEP_S}
    rep = run_live_job(code, A_blocks, B_blocks, PAPER_MN,
                       straggler_sleep=sleepers, num_chunks=4)
    used = np.flatnonzero(rep.worker_progress).tolist()
    rel = max(_rel_err(g, w) for g, w in zip(rep.blocks, truth))
    check(rep.sim_compute_time < LIVE_SLEEP_S,
          f"live_job: compute took {rep.sim_compute_time} s, the sleepers {LIVE_SLEEP_S} s")
    check(rel <= DECODE_RTOL, f"live_job: rel err {rel} > {DECODE_RTOL}")
    check(_alive_workers("live-worker-") == [], "live_job: worker threads outlived the job")
    live = {"q": 4, "sleepers": sorted(sleepers), "sleep_s": LIVE_SLEEP_S,
            "compute_time_s": rep.sim_compute_time,
            "decode_wall_time_ms": rep.decode_wall_time * 1e3,
            "workers_used": used, "chunks_used": rep.chunks_used,
            "progress_of_sleepers": [rep.worker_progress[w] for w in sleepers],
            "rel_err": rel, "rtol": DECODE_RTOL}
    del rep

    # the same job on B blocks still in flight when it starts
    B_async, unfinished = _in_flight(B_blocks)
    check(unfinished, "live_job: the in-flight B blocks were finished before the job")
    rep = run_live_job(code, A_blocks, B_async, PAPER_MN, num_chunks=4)
    rel = max(_rel_err(g, w) for g, w in zip(rep.blocks, truth))
    check(rel <= DECODE_RTOL, f"live_job, inputs in flight: rel err {rel} > {DECODE_RTOL}")
    live["inputs_in_flight"] = {"spin_cycles": LIVE_SPIN_CYCLES, "unfinished_at_start": unfinished,
                                "compute_time_s": rep.sim_compute_time, "rel_err": rel}
    del rep, B_async

    jobs = [MuxJob(code=schemes.sparse_code(PAPER_MN, PAPER_MN, PAPER_WORKERS, seed=s),
                   A_blocks=A_blocks, B_blocks=B_blocks, n=PAPER_MN, num_chunks=q,
                   tag=f"seed {s}, q={q}") for s, q in ((0, 1), (1, 2), (2, 4))]
    with JobMux(PAPER_WORKERS, source="live", straggler_sleep=sleepers) as mux:
        t0 = time.perf_counter()
        results = mux.run(jobs)
        batch_s = time.perf_counter() - t0
        # a second batch on the same pool, on B blocks still in flight
        B_async, unfinished = _in_flight(B_blocks)
        check(unfinished, "live JobMux: the in-flight B blocks were finished before the batch")
        (late,) = mux.run([MuxJob(code=code, A_blocks=A_blocks, B_blocks=B_async,
                                  n=PAPER_MN, num_chunks=4, tag="inputs in flight")])
        del B_async
    check(_alive_workers("mux-worker-") == [], "live JobMux: worker threads outlived the pool")
    check(late.ok, f"live JobMux, inputs in flight: {late.error}")
    late_rel = max(_rel_err(g, w) for g, w in zip(late.blocks, truth))
    check(late_rel <= DECODE_RTOL, f"live JobMux, inputs in flight: rel err {late_rel}")
    mux_rows = []
    for res in results:
        check(res.ok, f"live JobMux {res.tag}: {res.error}")
        rel = max(_rel_err(g, w) for g, w in zip(res.blocks, truth))
        check(rel <= DECODE_RTOL, f"live JobMux {res.tag}: rel err {rel}")
        mux_rows.append({"tag": res.tag, "compute_time_s": res.report.sim_compute_time,
                         "decode_wall_time_ms": res.report.decode_wall_time * 1e3,
                         "workers_used": res.report.workers_used,
                         "chunks_used": res.report.chunks_used, "rel_err": rel})
    emit(phase="live_job", workers=PAPER_WORKERS, nnz_C=paper["nnz_C"], run_live_job=live,
         jobmux={"jobs": mux_rows, "batch_s": batch_s,
                 "inputs_in_flight": {"spin_cycles": LIVE_SPIN_CYCLES, "unfinished_at_start": unfinished,
                                      "compute_time_s": late.report.sim_compute_time,
                                      "rel_err": late_rel}},
         rtol=DECODE_RTOL)


# ------------------------------- phase 9 ------------------------------------

def _counted(fn):
    """fn() run with every kernel's launch count set to 0 just before it,
    and the counts read just after."""
    from repro_torch.kernels import coded_accum, spmm_block

    spmm_block.reset_launch_counts()
    coded_accum.reset_launch_counts()
    out = fn()
    return out, {**spmm_block.LAUNCHES, **coded_accum.LAUNCHES}


@contextlib.contextmanager
def _card_memory_watch(out: dict):
    """The most device memory the block took from the card as a whole
    (every process's: ``torch.cuda.mem_get_info`` polled every 20 ms
    from the master) into ``out["peak_bytes"]``."""
    free0 = torch.cuda.mem_get_info()[0]
    seen, stop = [free0], threading.Event()

    def poll():
        while not stop.wait(0.02):
            seen.append(torch.cuda.mem_get_info()[0])

    watcher = threading.Thread(target=poll, daemon=True)
    watcher.start()
    try:
        yield
    finally:
        stop.set()
        watcher.join()
        out["peak_bytes"] = free0 - min(seen)


def _startup(hellos: list, go_s: float | None = None) -> dict:
    """A pool's start-up over its worker processes: the median and the
    largest of each part its workers reported (spawn to hello, and its
    split: to the worker's entry point, to open the device, to put its
    operands there)."""
    out = {"processes": len(hellos), **({"go_s": go_s} if go_s is not None else {})}
    for key in ("hello_s", "entry_s", "device_s", "operands_s"):
        secs = sorted(h[key] for h in hellos if key in h)
        if secs:
            out[key] = {"median": statistics.median(secs), "max": secs[-1]}
    return out


def phase_proc_job(paper: dict) -> None:
    """``run_proc_job`` on the card at the paper's operands (q = 4): worker
    processes, each with a CUDA context of its own, computing their coded
    CSR products there; a line a case, then a summary line.  First the live job's case (workers 0 and 1
    sleeping 2 s, the others not) beside ``live_job``'s thread compute, with
    the card memory the 28 processes take; then a no-fault run that
    calibrates the simulator's ``unit_block_time``; then each fault class
    -- kill, pause, slow, drop_result -- checked to have fired, decoded
    within DECODE_RTOL, beside ``FaultRealization``'s predicted recovery;
    a respawn after a kill at spawn on an ``uncoded`` job, which needs the
    fresh process; and an unrecoverable kill, which must raise naming worker 1."""
    from repro_torch.core import schemes
    from repro_torch.core.decoder import DecodingError
    from repro_torch.runtime import NoStragglers, run_coded_job, run_proc_job
    from repro_torch.runtime.chaos import (FaultPlan, FaultRealization, drop_result,
                                           kill, pause, slow)

    A_blocks, B_blocks, truth = paper["A"], paper["B"], paper["truth"]
    code = schemes.sparse_code(PAPER_MN, PAPER_MN, PAPER_WORKERS, seed=SEED)
    uncoded = schemes.uncoded(PAPER_MN, PAPER_MN)

    def run(c, plan=None, faulted=None, sleep=None, **kw):
        if sleep is None:
            sleep = {w: PROC_FAULTED_SLEEP_S if w == faulted else PROC_SLEEP_S
                     for w in range(c.num_workers)}
        t0 = time.perf_counter()
        rep = run_proc_job(c, A_blocks, B_blocks, PAPER_MN, straggler_sleep=sleep,
                           num_chunks=PROC_Q, plan=plan, timeout=PROC_TIMEOUT_S,
                           heartbeat_deadline=PROC_DEADLINE_S, **kw)
        return rep, time.perf_counter() - t0

    def predicted(plan, unit):
        return run_coded_job(code, truth, FaultRealization(plan=FaultPlan.coerce(plan)),
                             rng=np.random.default_rng(SEED), unit_block_time=unit,
                             num_chunks=PROC_Q).sim_compute_time

    def row(name, rep, wall_s, plan=None):
        rel = max(_rel_err(g, w) for g, w in zip(rep.blocks, truth))
        check(rel <= DECODE_RTOL, f"proc_job {name}: rel err {rel} > {DECODE_RTOL}")
        check(sorted({str(b.layout) for b in rep.blocks}) == ["torch.sparse_csr"],
              f"proc_job {name}: a decoded block is not CSR")
        startup = rep.decode_stats["startup"]
        return {"case": name, "plan": [repr(f) for f in (plan or [])],
                "compute_s": rep.sim_compute_time,
                "decode_ms": rep.decode_wall_time * 1e3,
                "workers_used": rep.workers_used, "chunks_used": rep.chunks_used,
                "ledger": [[e["kind"], e["worker"]] + ([e["exitcode"]] if "exitcode" in e else [])
                           for e in rep.fault_ledger],
                "faults": {k: rep.decode_stats["faults"][k] for k in
                           ("equations_lost", "equations_recovered")},
                "rel_err": rel, "rtol": DECODE_RTOL,
                "startup": _startup(startup["hello"], startup["go_s"]),
                "wall_s": wall_s}

    # a chunk's products alone on the card (the master's own context), the
    # yardstick of the processes' compute: workers 0-3's chunks, each timed
    # from a synchronisation to a synchronisation
    from repro_torch.core.encoder import encode_blocks, make_tasks

    tasks = {t.worker: t for t in make_tasks(code.M)}
    alone = []
    for w in range(4):
        for r in code.worker_rows[w]:
            for task in tasks[r].chunks(PROC_Q):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                encode_blocks(task, A_blocks, B_blocks, PAPER_MN)
                torch.cuda.synchronize()
                alone.append(time.perf_counter() - t0)
    chunk_ms_alone = statistics.median(alone) * 1e3

    rows = []
    # the live job's case: the same sleepers, beside the threads' compute
    memory = {}
    with _card_memory_watch(memory):
        rep, wall = run(code, sleep={0: LIVE_SLEEP_S, 1: LIVE_SLEEP_S})
    rows.append(row("as live_job (workers 0, 1 sleep 2 s)", rep, wall))
    rows[-1].update(card_bytes_taken=memory["peak_bytes"],
                    card_bytes_per_process=memory["peak_bytes"] / PAPER_WORKERS,
                    progress_of_sleepers=rep.worker_progress[:2],
                    chunk_ms_alone=chunk_ms_alone,
                    chunks_used_times_chunk_alone_s=rep.chunks_used * chunk_ms_alone / 1e3)
    emit(phase="proc_job", **rows[-1])

    # no fault: calibrates the simulator's clock (as the JAX package's chaos
    # benchmark does)
    rep, wall = run(code)
    rows.append(row("no fault", rep, wall))
    sim_base = run_coded_job(code, truth, NoStragglers(), rng=np.random.default_rng(SEED),
                             unit_block_time=1.0, num_chunks=PROC_Q).sim_compute_time
    unit = rep.sim_compute_time / sim_base
    rows[-1].update(predicted_s=predicted([], unit), unit_block_time=unit)
    emit(phase="proc_job", **rows[-1])
    check(rep.fault_ledger == [], f"proc_job no fault: ledger {rep.fault_ledger}")

    for name, fault in (("kill", kill(1, after_chunk=0)), ("pause", pause(2, after_chunk=0)),
                        ("slow10x", slow(3, factor=10.0)),
                        ("drop_result", drop_result(1, chunk=1))):
        rep, wall = run(code, [fault], faulted=fault.worker)
        rows.append(row(name, rep, wall, [fault]))
        pred = predicted([fault], unit)
        rows[-1].update(predicted_s=pred, measured_over_predicted=rep.sim_compute_time / pred)
        emit(phase="proc_job", **rows[-1])
        check(any(e["kind"] == fault.kind and e["worker"] == fault.worker
                  for e in rep.fault_ledger),
              f"proc_job {name}: the fault did not fire: {rep.fault_ledger}")

    # respawn after a kill: uncoded needs the fresh process (its one
    # equation a worker, at q = 4, lies in a single chunk)
    fault = kill(1)
    rep, wall = run(uncoded, [fault], respawn=True)
    rows.append(row("uncoded, kill + respawn", rep, wall, [fault]))
    again = [h for h in rep.decode_stats["startup"]["hello"] if h["worker"] == 1]
    rows[-1]["respawn_startup"] = again[1:]
    emit(phase="proc_job", **rows[-1])
    kinds = [e["kind"] for e in rep.fault_ledger]
    check(kinds == ["kill", "crash_detected", "respawn"], f"proc_job respawn: ledger {kinds}")
    check(rep.fault_ledger[1]["exitcode"] == -9, f"proc_job respawn: {rep.fault_ledger[1]}")
    check(len(again) == 2, f"proc_job respawn: worker 1 said hello {len(again)} times")

    # unrecoverable: uncoded without worker 1
    t0 = time.perf_counter()
    err = None
    try:
        run(uncoded, [kill(1)])
    except DecodingError as exc:
        err = str(exc)
    rows.append({"case": "uncoded, kill(1) at spawn", "plan": [repr(kill(1))],
                 "error": err, "wall_s": time.perf_counter() - t0})
    emit(phase="proc_job", **rows[-1])
    check(err is not None and "[1]" in err, f"proc_job unrecoverable: raised {err!r}")
    emit(phase="proc_job", workers=PAPER_WORKERS, q=PROC_Q, nnz_C=paper["nnz_C"],
         sleep_s=PROC_SLEEP_S, faulted_sleep_s=PROC_FAULTED_SLEEP_S,
         heartbeat_deadline_s=PROC_DEADLINE_S,
         cases=[{k: r[k] for k in ("case", "compute_s", "decode_ms", "rel_err", "wall_s")
                 if k in r} for r in rows])


# ------------------------------- phase 10 -----------------------------------

def phase_proc_mux(paper: dict) -> None:
    """``JobMux`` over a ``MuxProcPool`` of 28 worker processes on the card,
    worker 1 killed when its first chunk arrives: one batch of two coded
    jobs, which decode within DECODE_RTOL, and one uncoded job that needs
    worker 1, which fails alone."""
    from repro_torch.core import schemes
    from repro_torch.runtime import JobMux, MuxJob, MuxProcPool
    from repro_torch.runtime.chaos import kill

    A_blocks, B_blocks, truth = paper["A"], paper["B"], paper["truth"]
    jobs = [MuxJob(code=code, A_blocks=A_blocks, B_blocks=B_blocks, n=PAPER_MN,
                   num_chunks=q, tag=tag) for code, q, tag in (
        (schemes.sparse_code(PAPER_MN, PAPER_MN, PAPER_WORKERS, seed=0), 2, "coded seed 0, q=2"),
        (schemes.sparse_code(PAPER_MN, PAPER_MN, PAPER_WORKERS, seed=1), 1, "coded seed 1, q=1"),
        (schemes.uncoded(PAPER_MN, PAPER_MN), 2, "uncoded, q=2"))]
    pool = MuxProcPool(PAPER_WORKERS, plan=[kill(1, after_chunk=0)],
                       straggler_sleep={w: PROC_SLEEP_S / 2 for w in range(PAPER_WORKERS)},
                       timeout=PROC_TIMEOUT_S)
    with JobMux(PAPER_WORKERS, source=pool) as mux:
        procs = list(pool._procs.values())
        t0 = time.perf_counter()
        results = mux.run(jobs)
        batch_s = time.perf_counter() - t0
    check(all(not p.is_alive() for p in procs), "proc_mux: a worker process outlived the pool")
    rows = []
    for res in results[:2]:
        check(res.ok, f"proc_mux {res.tag}: {res.error}")
        rel = max(_rel_err(g, w) for g, w in zip(res.blocks, truth))
        check(rel <= DECODE_RTOL, f"proc_mux {res.tag}: rel err {rel}")
        check(res.report.worker_progress[1] <= 1,
              f"proc_mux {res.tag}: worker 1 delivered after its kill")
        rows.append({"tag": res.tag, "compute_s": res.report.sim_compute_time,
                     "decode_ms": res.report.decode_wall_time * 1e3,
                     "workers_used": res.report.workers_used,
                     "chunks_used": res.report.chunks_used, "rel_err": rel})
    bad = results[2]
    check(not bad.ok and "worker process(es) [1] crashed" in bad.error,
          f"proc_mux {bad.tag}: ok={bad.ok}, error {bad.error!r}")
    rows.append({"tag": bad.tag, "error": bad.error})
    ledger = [[e["kind"], e["worker"]] + ([e["exitcode"]] if "exitcode" in e else [])
              for e in pool.ledger.entries]
    check(ledger == [["kill", 1], ["crash_detected", 1, -9]], f"proc_mux: ledger {ledger}")
    emit(phase="proc_mux", workers=PAPER_WORKERS, sleep_s=PROC_SLEEP_S / 2, jobs=rows,
         batch_s=batch_s, ledger=ledger,
         startup=_startup(list(pool.startup.values())), rtol=DECODE_RTOL)


# ------------------------------- phase 6b -----------------------------------

def phase_schemes(full: dict) -> None:
    """The port's scheme checks over every registered scheme at their
    default sweep (no ``ERROR`` finding), and the pack contracts on the main
    path's full-size operand and pack."""
    from repro_torch.analysis import ERROR, WARNING
    from repro_torch.analysis.schemes import run_scheme_checks, validate_pack
    from repro_torch.coded.registry import scheme_names
    from repro_torch.core.coded_matmul import pack_worker_tiles

    t0 = time.perf_counter()
    findings, count = run_scheme_checks()
    sweep_s = time.perf_counter() - t0
    errors = [f.render() for f in findings if f.severity == ERROR]
    check(count == len(scheme_names()) and not errors,
          f"schemes: {count} checked, errors {errors}")
    t0 = time.perf_counter()
    A_np = full["A"].cpu().numpy()
    pack = pack_worker_tiles(full["ell"], full["plan"])
    pack_findings = [f.render() for f in validate_pack(full["plan"], A_np, full["ell"], pack)]
    check(pack_findings == [], f"schemes: the main path's pack: {pack_findings}")
    emit(phase="schemes", schemes_checked=count, errors=len(errors),
         warnings=[f.render() for f in findings if f.severity == WARNING],
         sweep_s=sweep_s,
         main_path_pack={"workers": WORKERS, "s": S, "r": R, "density": DENSITY,
                         "vals_shape": list(pack.vals.shape),
                         "live_tiles": int(pack.live_tiles.sum()),
                         "findings": pack_findings, "seconds": time.perf_counter() - t0})


def profile_apply(fn) -> dict:
    """Device time by kernel over one warm call of fn (torch.profiler), and
    the device's idle share of the call's wall time.  Where the trace holds
    no device time, both are None: not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in kernels)
    return {"wall_ms": wall_ms, "device_busy_ms": busy or None,
            "device_idle_share": 1.0 - busy / wall_ms if busy else None,
            "by_kernel": [{"name": name[:96], "ms": ms, "count": count}
                          for name, ms, count in kernels[:6]]}


def _host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails here when run outside the repo)

    info = phase_device()
    built = phase_build()
    phase_kernels()
    phase_entry_kernels()
    phase_accum_tiles()
    kernels, full = phase_main(built)
    kernels += phase_entry_full(full, built)
    by_path = {"device_job": phase_device_job(full)}
    _, by_path["schemes"] = _counted(lambda: phase_schemes(full))
    paper = phase_straggler_job(full, torch.device("cuda", 0))
    del full
    torch.cuda.empty_cache()
    phase_live_job(paper)
    _, by_path["proc_job"] = _counted(lambda: phase_proc_job(paper))
    _, by_path["proc_mux"] = _counted(lambda: phase_proc_mux(paper))
    for path in ("schemes", "proc_job", "proc_mux"):  # they run none of the kernels
        check(not any(by_path[path].values()), f"{path} launched {by_path[path]}")
    for row in kernels:  # each path's counts, read on their own, and their sum
        row["launches_by_path"] = {"main": row["launches"], **{
            path: counts.get(row["name"], 0) for path, counts in by_path.items()}}
        row["launches"] = sum(row["launches_by_path"].values())
    print(info["nvidia_smi"], flush=True)  # again, beside the results
    emit(kernels=kernels)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
