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
full-size pack.  ``serving`` drives the serving port at the full width of
qwen3-moe-30b-a3b (4 of its 48 layers): one layer on the card against the
CPU on the same weights, cached decode against one forward, the coded
expert FFN against the plain one (two of its 130 workers dead, and a
survivor set that loses rank refused), prefill and decode times, and
``ServingEngine`` over ``JobMux("live")`` -- coded and uncoded, healthy
and with worker 0 dead -- and over a ``MuxProcPool`` with worker 1
killed; it launches none of the kernels.  ``train`` drives the training
path at the full width of internlm2-1.8b: five train steps at full depth
(the loss, the gradient norm, the step time, the peak memory), one layer
on the card against the CPU with each cross entropy, the training CLI
through a simulated failure and its resume, a coded checkpoint of one
layer's parameters restored from all of its targets and from two thirds
of them, and the coded expert FFN's gradients (qwen3-moe-30b-a3b, one
layer, two workers dead) against the plain FFN's; it launches none of the
kernels either.  ``families`` drives the four families with other mixers
at their published widths: rwkv6-3b at full depth (one layer on the card
against the CPU with its gradients, ``generate``, cached decode against
one forward at f32 and bf16 caches, train steps), jamba-1.5-large-398b's
mamba mixer alone at full width (card against CPU with gradients, its
state-carrying decode against its forward) and the whole model at
reduced() (card against CPU, and served with worker 0 dead),
llama-3.2-vision-11b at full depth with image tokens and whisper-medium
at full depth with frames (one layer group against the CPU, ``generate``,
cached decode against one forward; whisper's train steps and its training
CLI); it launches none of the kernels.  ``launch`` drives the launch
tooling: the H100 data sheet's peaks beside the card's own (calibrated),
the JAX package's kernel roofline of the fused-decode kernel's heaviest
launch (added to its row), the dry run of internlm2-1.8b at full width
and depth on meta held to the card's allocator -- a train step (4 x 512)
and a decode token (4 x a 4096-token cache): the arguments' bytes within
0.5% + 1 MiB, the peak printed beside its estimate -- and one full-size
roofline analysis; it launches none of the kernels.  Worker processes
start from a fork server and re-import this script: nothing at its
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
import os
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


# ------------------------------- phase 8b -----------------------------------
# the serving path at the full width of qwen3-moe-30b-a3b, the JAX package's
# MoE config (hf:Qwen/Qwen3-30B-A3B: d_model 2048, 32 heads over 4 KV heads
# of 128, 128 experts top-8 of d_ff 768, vocabulary 151,936, untied head),
# cut in depth only: 4 of its 48 layers
SERVE_ARCH, SERVE_LAYERS, SERVE_STEPS = "qwen3-moe-30b-a3b", 4, 4
SERVE_PROMPTS, SERVE_NEW_TOKENS, SERVE_REQUESTS, SERVE_MAX_SEQ = (32, 128), (8, 16), 8, 256
SERVE_WORKERS, SERVE_BLOCKS, SERVE_CHUNKS, SERVE_BATCH = 6, 4, 2, 4
SERVE_DEAD, SERVE_LOST = (0, 1), (0, 1, 2)  # of the expert code's 130 workers
# The engine's checks run on an 8-request burst (serve_demo's rates, all
# arriving within 0.2 s): a functional smoke, too short for a tail.  Its
# latencies are read from a longer window: 64 requests of the same two
# tenants at 1/16 of their rates (2.31 requests/s, 720 tokens arriving
# over 30.4 s, about 24 tokens/s offered), below what the engine served
# in the bursts (38-48 tokens/s on an H100 80GB HBM3 at 700 W), so
# queueing stays bounded.
SERVE_LOAD_REQUESTS, SERVE_LOAD_RATE_SCALE, SERVE_LOAD_HORIZON = 64, 1 / 16, 60.0
# logits against logits, relative to the reference's max|logit|.  Card vs
# CPU, and cached decode vs one forward, are the same f32 products summed
# in other orders: over d = 2048 that rounds near sqrt(2048) * eps32 =
# 2.7e-6 of a product's scale, a few products deep; bf16 anywhere would
# miss 1e-4 by an order of magnitude.  The coded expert FFN adds its
# decode's error: an H100 80GB HBM3 read 7.1e-7 healthy and 5.4e-6 with
# workers 0 and 1 dead, so 1e-4 holds it to f32 too (TF32 or bf16 in the coded
# products would exceed it).  The rebound decode itself, on the card in
# float64: its dead workers' columns within 1e-9 of zero (5.6e-14 on the
# CPU) and D over the survivors times their encode rows within 1e-4 of I
# (1.5e-6 healthy, 2.3e-5 with workers 0 and 1 dead, on the CPU; the
# full-survivor D over the same survivors is 2.5 from I).
SERVE_RTOL, SERVE_CODED_RTOL, SERVE_DECODE_ATOL, SERVE_DEAD_COLS_ATOL = 1e-4, 1e-4, 1e-4, 1e-9


def _tree_to(tree: dict, device) -> dict:
    """A copy of the tree on ``device`` (a copy even where it is there
    already, as when a rehearsal's card is the CPU)."""
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device, copy=True)
            for k, v in tree.items()}


def _greedy(model, params, prompt: torch.Tensor, steps: int, D=None):
    """Prefill ``prompt`` (f32 cache, as the engine keeps it), then ``steps``
    greedy decode steps: each step's last-position logits (on the host) and
    the tokens.  ``D`` is the expert code's decode matrix, where coded."""
    from repro_torch.models import moe

    ctx = moe.coded_moe_decode(D) if D is not None else contextlib.nullcontext()
    with ctx:
        logits, cache = model.prefill(params, prompt, max_seq=prompt.shape[1] + steps,
                                      cache_dtype=torch.float32)
        out, toks = [logits[:, -1].cpu()], []
        for _ in range(steps):
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            toks.append(tok.cpu())
            logits, cache = model.decode_step(params, cache, tok)
            out.append(logits[:, -1].cpu())
    return torch.stack(out, 1), torch.cat(toks, 1)


def _logit_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _wall_ms(fn, dev, reps: int = 3) -> float:
    """Median host-clock time of fn() ending in a synchronize, after one
    warm-up call."""
    from repro_torch.core.blocks import synchronize

    fn()
    synchronize(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_serving(smi: str, dev: torch.device) -> None:
    """The serving port at full width on the card: (a) one layer on the
    card and again on the CPU on the same weights; (b) prefill then decode
    steps against one forward over the same tokens, dropless; (c) the coded
    expert FFN against the plain one, healthy and with two of its workers
    dead (the rebound decode checked on the card), and a survivor set that
    loses rank refused before any step; (d) ``ServingEngine`` over
    ``JobMux("live")`` on an 8-request burst, coded and uncoded, healthy
    and with worker 0 dead, then over a ``MuxProcPool`` with worker 1
    killed; then coded and uncoded, healthy, over a 64-request window, for
    the latencies.  The prefill and decode times, the engine's summaries
    and the card memory are printed beside the card's name and power
    limit."""
    from repro_torch import configs
    from repro_torch.core.decoder import DecodingError
    from repro_torch.models import build, moe
    from repro_torch.runtime.chaos import kill
    from repro_torch.runtime.procpool import MuxProcPool
    from repro_torch.serving import SLO, ServingEngine, TenantSpec, poisson_trace

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.get(SERVE_ARCH), num_layers=SERVE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, SERVE_PROMPTS[0]))
                              .astype(np.int32)).to(dev)
    out = {"config": {"arch": cfg.name, "d_model": cfg.d_model, "heads": cfg.num_heads,
                      "kv_heads": cfg.num_kv_heads, "head_dim": cfg.hd,
                      "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
                      "expert_d_ff": cfg.moe.d_ff, "vocab": cfg.vocab_size,
                      "capacity_factor": cfg.moe.capacity_factor,
                      "coded_moe_workers": moe.coded_moe_num_workers(cfg)},
           "reduced": {"num_layers": [configs.get(SERVE_ARCH).num_layers, cfg.num_layers]}}

    # (a) the same weights, one layer, on the card and on the CPU
    one = dataclasses.replace(cfg, num_layers=1)
    model = build(one, dev)
    p1 = model.init(SEED)
    card, card_tok = _greedy(model, p1, prompt, SERVE_STEPS)
    t0 = time.perf_counter()
    host, host_tok = _greedy(build(one, "cpu"), _tree_to(p1, "cpu"), prompt.cpu(), SERVE_STEPS)
    err = _logit_err(card, host)
    check(err <= SERVE_RTOL and torch.equal(card_tok, host_tok),
          f"serving (a): card vs CPU logits err {err}, tokens {card_tok} vs {host_tok}")
    out["card_vs_cpu"] = {"layers": 1, "logits_err": err, "rtol": SERVE_RTOL,
                          "tokens": card_tok[0].tolist(), "cpu_s": time.perf_counter() - t0}
    del p1, model

    params = build(cfg, dev).init(SEED)
    params_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    out["memory"] = {"params_bytes": params_bytes,
                     "allocated_after_init_bytes": torch.cuda.memory_allocated()}

    # (b) prefill + decode == one forward, with nothing dropped
    dropless = build(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts))), dev)
    steps, toks = _greedy(dropless, params, prompt, SERVE_STEPS)
    fed = torch.cat([prompt, toks.to(dev)], 1)
    x, _, _ = dropless.forward(params, fed)
    full = dropless.logits(params, x)[:, prompt.shape[1] - 1:].cpu()
    err = _logit_err(steps, full)
    check(err <= SERVE_RTOL and torch.equal(toks, full.argmax(-1)[:, :SERVE_STEPS].int()),
          f"serving (b): cached decode vs forward logits err {err}")
    out["decode_vs_forward"] = {"capacity_factor": float(cfg.moe.num_experts),
                                "logits_err": err, "rtol": SERVE_RTOL}
    del dropless, x

    # (c) the coded expert FFN against the plain one
    plain, coded = build(cfg, dev), build(cfg.with_opts(["coded_moe"]), dev)
    want, want_tok = _greedy(plain, params, prompt, SERVE_STEPS)
    N, E = moe.coded_moe_num_workers(cfg), cfg.moe.num_experts
    t0 = time.perf_counter()
    moe.coded_moe_decode_matrix(cfg)
    out["coded"] = {"workers": N, "plan_s": time.perf_counter() - t0, "rtol": SERVE_CODED_RTOL,
                    "decode_atol": SERVE_DECODE_ATOL, "dead_cols_atol": SERVE_DEAD_COLS_ATOL}
    enc = moe._coded_moe_mats(cfg.coded.scheme, E, N, dev)[0].double()  # (N, E)
    eye = torch.eye(E, dtype=torch.float64, device=dev)
    for dead in ((), SERVE_DEAD):
        surv = np.ones(N, dtype=bool)
        surv[list(dead)] = False
        D = torch.as_tensor(moe.coded_moe_decode_matrix(cfg, surv), device=dev)
        # every worker's output is computed, so the logits alone would pass
        # an unbound D too: the rebind is held here
        live = torch.as_tensor(surv, device=dev)
        dead_cols = float(D[:, ~live].abs().max()) if dead else 0.0
        decode_err = float((D.double()[:, live] @ enc[live] - eye).abs().max())
        check(dead_cols <= SERVE_DEAD_COLS_ATOL and decode_err <= SERVE_DECODE_ATOL,
              f"serving (c): decode rebound for dead {dead}: dead columns {dead_cols}, "
              f"|D M - I| {decode_err}")
        got, got_tok = _greedy(coded, params, prompt, SERVE_STEPS, D)
        err = _logit_err(got, want)
        check(err <= SERVE_CODED_RTOL and torch.equal(got_tok, want_tok),
              f"serving (c): coded, dead {dead}: logits err {err}, tokens {got_tok} vs {want_tok}")
        out["coded"][f"dead_{list(dead)}"] = {"logits_err": err, "decode_err": decode_err,
                                              "dead_cols_max": dead_cols}
    lost = np.ones(N, dtype=bool)
    lost[list(SERVE_LOST)] = False
    try:
        moe.coded_moe_decode_matrix(cfg, lost)
        raised = False
    except DecodingError:
        raised = True
    check(raised, f"serving (c): survivors without workers {SERVE_LOST} decoded")

    # the steps' times: prefill per prompt length, decode per token
    times = {}
    for name, model, D in (("plain", plain, None),
                           ("coded", coded, torch.as_tensor(moe.coded_moe_decode_matrix(cfg),
                                                            device=dev))):
        ctx = moe.coded_moe_decode(D) if D is not None else contextlib.nullcontext()
        with ctx:
            row = {}
            for plen in SERVE_PROMPTS:
                toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, plen))
                                        .astype(np.int32)).to(dev)
                row[f"prefill_{plen}_ms"] = _wall_ms(lambda: model.prefill(
                    params, toks, max_seq=SERVE_MAX_SEQ, cache_dtype=torch.float32), dev)
            _, cache = model.prefill(params, prompt, max_seq=SERVE_MAX_SEQ,
                                     cache_dtype=torch.float32)
            tok = prompt[:, -1:]
            state = {"cache": cache}

            def step():
                _, state["cache"] = model.decode_step(params, state["cache"], tok)

            row["decode_ms_per_token"] = _wall_ms(step, dev, reps=8)
        times[name] = row
    out["times"] = times
    del plain, coded, cache, state

    # (d) the engine, over JobMux("live") on the card, then a process pool
    tenants = [TenantSpec("interactive", rate=25.0, prompt_len=SERVE_PROMPTS[0],
                          max_new_tokens=SERVE_NEW_TOKENS[0], slo=SLO(ttft=120.0, per_token=60.0)),
               TenantSpec("batch", rate=12.0, prompt_len=SERVE_PROMPTS[1],
                          max_new_tokens=SERVE_NEW_TOKENS[1], slo=SLO(ttft=240.0, per_token=120.0))]
    burst = lambda: poisson_trace(tenants, horizon=0.5, seed=5,  # noqa: E731
                                  max_requests=SERVE_REQUESTS)
    check(len({r.tenant for r in burst()}) == 2, "serving (d): want both tenants in the trace")

    def serve(coded_arm: bool, trace=burst, **kw) -> tuple[dict, dict]:
        eng = ServingEngine(cfg, coded=coded_arm, num_workers=SERVE_WORKERS,
                            n_blocks=SERVE_BLOCKS, num_chunks=SERVE_CHUNKS,
                            max_batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ, seed=SEED,
                            device=dev, params=params, **kw)
        t0 = time.perf_counter()
        with eng:
            eng.warmup(SERVE_PROMPTS)
            ready_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            reqs = trace()
            metrics = eng.run(reqs)
            wall = time.perf_counter() - t0
        s = metrics.summary()
        s.update(wall_s=wall, ready_s=ready_s, last_arrival_s=reqs[-1].arrival_time,
                 tokens_per_s=s["tokens"] / wall if wall > 0 else None,
                 errors=sorted({r.error for r in metrics.requests if r.error}))
        return s, {r.rid: r.tokens for r in metrics.requests}

    arms, tokens = {}, {}
    for coded_arm in (True, False):
        for dead in ((), (0,)):
            key = f"{'coded' if coded_arm else 'uncoded'}_{'worker0_dead' if dead else 'healthy'}"
            arms[key], tokens[key] = serve(coded_arm, source="live", dead_workers=dead)
    check(tokens["coded_healthy"] == tokens["uncoded_healthy"],
          "serving (d): coded and uncoded arms gave different tokens")
    for key in ("coded_healthy", "uncoded_healthy", "coded_worker0_dead"):
        check(arms[key]["completed"] == SERVE_REQUESTS, f"serving (d) {key}: {arms[key]}")
    check(arms["coded_worker0_dead"]["straggler_recoveries"] >= 1,
          f"serving (d): no straggler recovery with worker 0 dead: {arms['coded_worker0_dead']}")
    check(arms["uncoded_worker0_dead"]["completed"] == 0,
          f"serving (d): uncoded with worker 0 dead completed: {arms['uncoded_worker0_dead']}")

    pool = MuxProcPool(SERVE_WORKERS, plan=[kill(1, after_chunk=0)], timeout=PROC_TIMEOUT_S,
                       device=dev)
    arms["coded_procpool_worker1_killed"], tokens["proc"] = serve(True, source=pool)
    procs = list(pool._procs.values())
    kinds = sorted({e["kind"] for e in pool.ledger.entries})
    s = arms["coded_procpool_worker1_killed"]
    s["ledger_kinds"] = kinds
    s["startup"] = _startup(list(pool.startup.values()))
    check(all(not p.is_alive() for p in procs), "serving (d): a worker process outlived the pool")
    check(s["completed"] == SERVE_REQUESTS and "kill" in kinds and s["straggler_recoveries"] >= 1
          and tokens["proc"] == tokens["coded_healthy"], f"serving (d) process pool: {s}")
    out["engine"] = arms

    # the latencies, over a window long enough for a tail
    slow = [dataclasses.replace(t, rate=t.rate * SERVE_LOAD_RATE_SCALE) for t in tenants]
    window = lambda: poisson_trace(slow, horizon=SERVE_LOAD_HORIZON, seed=5,  # noqa: E731
                                   max_requests=SERVE_LOAD_REQUESTS)
    load, load_tokens = {"rate_scale": SERVE_LOAD_RATE_SCALE}, {}
    for coded_arm in (True, False):
        key = "coded_healthy" if coded_arm else "uncoded_healthy"
        load[key], load_tokens[key] = serve(coded_arm, trace=window, source="live")
        check(load[key]["completed"] == SERVE_LOAD_REQUESTS, f"serving (d) load {key}: {load[key]}")
    check(load_tokens["coded_healthy"] == load_tokens["uncoded_healthy"],
          "serving (d) load: coded and uncoded arms gave different tokens")
    out["engine_load"] = load
    out["memory"]["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    del params
    print(smi, flush=True)
    emit(phase="serving", nvidia_smi=smi, seconds=time.perf_counter() - t_phase, **out)


def _leaves(tree):
    """The tensors of a tree of dicts and lists (a mamba cache's)."""
    for v in (tree.values() if isinstance(tree, dict) else tree):
        yield from (_leaves(v) if isinstance(v, (dict, list)) else (v,))


# ------------------------------- phase 8c -----------------------------------
# the training path at the full width of internlm2-1.8b (the JAX package's
# trainer's config, arXiv:2403.17297: d_model 2048, 16 heads over 8 KV
# heads of 128, SwiGLU d_ff 8192, vocabulary 92,544, untied head, 24
# layers; 1.89 B parameters, 30 GB with their gradients and f32 Adam
# moments): (a) five steps at full depth, batch 4 x 512 from
# SyntheticCorpus, chunked cross entropy; (b) one layer deep, batch 1 x 128,
# the card against the CPU on the same parameters; (c) the CLI two layers
# deep; (d) one layer group's parameters (63 M floats) as a coded
# checkpoint, m = n = 4 over 24 targets; (e) one layer of qwen3-moe-30b-a3b
# (serving's config) with the coded expert FFN, workers 0 and 1 dead.
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "internlm2-1.8b", 4, 512, 5
TRAIN_LR, TRAIN_WARMUP = 3e-4, 20  # the CLI's defaults
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, TRAIN_CPU_STEPS = 1, 128, 2
TRAIN_CLI = ["--layers", "2", "--steps", "7", "--batch", "2", "--seq", "256",
             "--ckpt-every", "5", "--warmup", "2", "--opt-dtype", "bfloat16"]
TRAIN_CLI_FAIL, TRAIN_CLI_TIMEOUT_S = 6, 300
TRAIN_CODED_M, TRAIN_CODED_TARGETS, TRAIN_CODED_DROP = 4, 24, 8
TRAIN_MOE_BATCH, TRAIN_MOE_SEQ = 2, 128
# step 0's loss against ln V: at init the head's logits are about normal
# with a std of sqrt(d) * 0.02 = 0.9 (the final norm's unit rms times the
# head's init scale), which puts E[logsumexp] near ln V + 0.9^2 / 2 and
# the label's logit near 0: within 1.0 of ln V
TRAIN_LOSS0_ATOL = 1.0
# card vs CPU, f32 with TF32 off: the loss within 1e-5 relative and the
# global gradient norm within 1e-4 (f32 sums in other orders); the first
# step's gradients within 1e-4 of each leaf's largest magnitude.  The
# fused cross entropy's backward products run in bf16: its gradients
# within one bf16 rounding of that (2^-7).  The parameters after each step
# within 2.02 lr a step of each other: Adam's first steps move every entry
# by about lr whatever its gradient's size (at most 1.0013 lr at step 2,
# plus the decay's lr * 0.01 * |p|), so a gradient near 0 that rounds to
# the other sign moves its entry the other way (the embedding's init scale
# is 1/sqrt(V) = 0.0033, so that is 1.5% of its largest entry).
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_GRAD_RTOL, TRAIN_BF16_RTOL = 1e-5, 1e-4, 1e-4, 2.0 ** -7
# the coded checkpoint's float64 targets decode to the f32 values: exact
# but for float64 rounding far below one f32 ulp
TRAIN_CKPT_ATOL = 1e-6
# coded vs plain expert FFN, loss and each gradient leaf relative to its
# largest magnitude: 1e-3.  The expert code (m = E = 128, n = 1) draws its
# weights from the paper's set 1..(mn)^2 = 16384, so a coded product's f32
# sums round at up to eps32 * 16384 = 1e-3 of the products' scale, and the
# backward runs its products through the transposed encode and decode.
# Serving's logits read 5.4e-6 (H100 80GB HBM3, 700 W); a gradient leaf
# that a few routed tokens make reads up to 1.03e-4 on the same card.
TRAIN_CODED_RTOL = 1e-3


def _tree_errs(got: dict, want: dict) -> tuple[float, float]:
    """The largest over leaves of max|got - want|, and of that over the
    leaf's max|want|."""
    from repro_torch.training.tree import tree_leaves

    worst_abs = worst_rel = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
        w = w.float().cpu()
        err = float((g.float().cpu() - w).abs().max())
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / max(float(w.abs().max()), 1e-30))
    return worst_abs, worst_rel


def _train_cli(dev: torch.device, ckpt: str, *extra: str) -> tuple[int, str, float]:
    """``python -m repro_torch.launch.train`` on the card (the CPU when
    rehearsed there): exit code, output, seconds."""
    import os

    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH,
           *TRAIN_CLI, "--ckpt-dir", ckpt, *extra,
           *([] if dev.type == "cuda" else ["--device", "cpu"])]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=TRAIN_CLI_TIMEOUT_S)
    return proc.returncode, proc.stdout + proc.stderr, time.perf_counter() - t0


def phase_train(smi: str, dev: torch.device) -> None:
    """The training path on the card, at internlm2-1.8b's full width: (a)
    full depth, five train steps: each step's loss and gradient norm, the
    step time, the peak memory, one step under the profiler; (d) one layer
    group's trained parameters as a coded checkpoint: restored from every
    target and with a third of them dropped, and refused from a subset that
    loses rank; (b) one layer, the card against the CPU on the same
    parameters and batches, with each cross entropy; (e) qwen3-moe-30b-a3b,
    one layer, a train step's loss and gradients with the coded expert FFN
    (workers 0 and 1 dead, the decode rebound) against the plain FFN's;
    (c) the training CLI two layers deep: a simulated failure, a resume
    from its checkpoint, and the end."""
    import random
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.core.blocks import synchronize
    from repro_torch.core.decoder import DecodingError
    from repro_torch.models import build, moe
    from repro_torch.training import AdamW, cosine_warmup_schedule, make_train_step
    from repro_torch.training.checkpoint import (restore_coded_checkpoint,
                                                 save_coded_checkpoint)
    from repro_torch.training.data import SyntheticCorpus
    from repro_torch.training.train_step import value_and_grad

    t_phase = time.perf_counter()
    cfg = configs.get(TRAIN_ARCH)
    out = {"config": {"arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
                      "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads, "head_dim": cfg.hd,
                      "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "batch": TRAIN_BATCH,
                      "seq": TRAIN_SEQ, "remat": cfg.remat}, "part_seconds": {}}

    def opt():
        return AdamW(lr=cosine_warmup_schedule(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))

    # (a) full width and depth
    t_part = time.perf_counter()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, dev)
    params = model.init(SEED)
    optimizer = opt()
    state = optimizer.init(params)
    step = make_train_step(model, optimizer)
    corpus = SyntheticCorpus(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    n_params = sum(t.numel() for t in _leaves(params))
    init_s = time.perf_counter() - t0
    rows = []
    for i in range(TRAIN_STEPS):
        batch = corpus.make_batch(i)
        synchronize(dev)
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        rows.append({"step": i, "loss": loss, "grad_norm": gnorm,
                     "s": time.perf_counter() - t0})
        print(f"train (a) step {i}: loss {loss:.4f} grad_norm {gnorm:.4f} "
              f"{rows[-1]['s']:.3f} s", flush=True)
    ln_v = math.log(cfg.vocab_size)
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows),
          f"train (a): a loss or gradient norm is not finite: {rows}")
    check(abs(rows[0]["loss"] - ln_v) <= TRAIN_LOSS0_ATOL,
          f"train (a): step 0 loss {rows[0]['loss']} is not within {TRAIN_LOSS0_ATOL} "
          f"of ln V = {ln_v}")
    check(all(torch.isfinite(t).all() for t in _leaves(params)),
          "train (a): a parameter is not finite after the steps")
    step_s = statistics.median(r["s"] for r in rows[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # the step's FLOPs: 8 N T for the products (forward, re-materialised
    # forward, backward; N without the embedding, a gather) and 16 L d S T
    # for the attention's scores and values (all S x S of them computed)
    dense = n_params - cfg.vocab_size * cfg.d_model
    flops = 8 * dense * tokens + 16 * cfg.num_layers * cfg.d_model * TRAIN_SEQ * tokens
    out["full"] = {"params": n_params, "steps": rows, "init_s": init_s,
                   "step_s_median_after_first": step_s, "tokens_per_s": tokens / step_s,
                   "ln_vocab": ln_v, "loss0_atol": TRAIN_LOSS0_ATOL,
                   "flops_per_step": flops, "f32_bound_s": flops / F32_FLOP_PER_S,
                   "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                   "params_bytes": 4 * n_params}
    if dev.type == "cuda":
        batch = corpus.make_batch(TRAIN_STEPS)
        out["full"]["profile_step"] = profile_apply(lambda: step(params, state, batch))
    print(f"train (a): {n_params:,} parameters, {step_s:.3f} s a step, peak "
          f"{out['full']['peak_allocated_bytes'] / 1e9:.2f} GB ({smi})", flush=True)

    out["part_seconds"]["a"] = time.perf_counter() - t_part
    # (d) a coded checkpoint of layer group 0's trained parameters
    t_part = time.perf_counter()
    payload = {k: v[0].clone() for k, v in _flat_items(params["groups"])}
    del model, step, state, optimizer, corpus
    params = None
    synchronize(dev)
    torch.cuda.empty_cache()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        coded = {"payload_floats": sum(t.numel() for t in payload.values()),
                 "m": TRAIN_CODED_M, "n": TRAIN_CODED_M, "targets": TRAIN_CODED_TARGETS,
                 "atol": TRAIN_CKPT_ATOL}
        t0 = time.perf_counter()
        manifest = save_coded_checkpoint(ckpt_dir, 1, payload, m=TRAIN_CODED_M,
                                         n=TRAIN_CODED_M, num_targets=TRAIN_CODED_TARGETS,
                                         device=dev)
        coded["save_s"] = time.perf_counter() - t0
        coded["bytes_on_disk"] = sum(p.stat().st_size for p in
                                     pathlib.Path(ckpt_dir).glob("coded_*/target_*.npz"))
        M = np.asarray(manifest["M_rows"])
        mn = TRAIN_CODED_M * TRAIN_CODED_M
        order = random.Random(SEED)
        keep = drop_bad = None
        for _ in range(200):  # a decodable subset, and one that loses rank
            rows_ = sorted(order.sample(range(TRAIN_CODED_TARGETS),
                                        TRAIN_CODED_TARGETS - TRAIN_CODED_DROP))
            full_rank = np.linalg.matrix_rank(M[rows_]) == mn
            keep = keep or (rows_ if full_rank else None)
            drop_bad = drop_bad or (None if full_rank else rows_)
            if keep and drop_bad:
                break
        check(keep is not None and drop_bad is not None,
              f"train (d): no decodable or no rank-losing subset of "
              f"{TRAIN_CODED_TARGETS - TRAIN_CODED_DROP} targets")
        for name, available in (("all", None), ("third_dropped", keep)):
            t0 = time.perf_counter()
            got, stats = restore_coded_checkpoint(ckpt_dir, 1, payload, available=available,
                                                  device=dev)
            secs = time.perf_counter() - t0
            err = max(float((got[k].float() - payload[k].float()).abs().max()) for k in payload)
            check(err <= TRAIN_CKPT_ATOL, f"train (d) {name}: restore err {err}")
            coded[name] = {"available": available, "restore_s": secs, "max_abs_err": err,
                           "stats": stats.as_dict()}
            del got
        try:
            restore_coded_checkpoint(ckpt_dir, 1, payload, available=drop_bad, device=dev)
            refused = False
        except DecodingError:
            refused = True
        check(refused, f"train (d): targets {drop_bad} lose rank but restored")
        coded["refused"] = {"available": drop_bad}
        out["coded_checkpoint"] = coded
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del payload
    torch.cuda.empty_cache()

    out["part_seconds"]["d"] = time.perf_counter() - t_part
    # (b) one layer, the card against the CPU, with each cross entropy
    t_part = time.perf_counter()
    one = dataclasses.replace(cfg, num_layers=1)
    vs_cpu = {}
    for ce in ("chunked", "fused"):
        c = one.with_opts(["fused_ce"]) if ce == "fused" else one
        card_model, host_model = build(c, dev), build(c, "cpu")
        p_card = card_model.init(SEED)
        p_host = _tree_to(p_card, "cpu")
        o = opt()
        s_card, s_host = o.init(p_card), o.init(p_host)
        st_card, st_host = make_train_step(card_model, o), make_train_step(host_model, o)
        corpus = SyntheticCorpus(c, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, seed=SEED)
        grad_rtol = TRAIN_BF16_RTOL if ce == "fused" else TRAIN_GRAD_RTOL
        t0 = time.perf_counter()
        _, g_host = value_and_grad(host_model, p_host, corpus.make_batch(0))
        cpu_s = time.perf_counter() - t0
        _, g_card = value_and_grad(card_model, p_card, corpus.make_batch(0))
        _, grads_rel = _tree_errs(g_card, g_host)
        check(grads_rel <= grad_rtol, f"train (b) {ce}: card vs CPU gradients {grads_rel}")
        del g_card, g_host
        steps, moved = [], 0.0
        for i in range(TRAIN_CPU_STEPS):
            batch = corpus.make_batch(i)
            _, _, mc = st_card(p_card, s_card, batch)
            t0 = time.perf_counter()
            _, _, mh = st_host(p_host, s_host, batch)
            cpu_s += time.perf_counter() - t0
            moved += 2.02 * float(o.lr(s_host["count"]))
            lc, lh = float(mc["loss"]), float(mh["loss"])
            gc, gh = float(mc["grad_norm"]), float(mh["grad_norm"])
            p_abs, p_rel = _tree_errs(p_card, p_host)
            row = {"loss_rel": abs(lc - lh) / abs(lh), "grad_norm_rel": abs(gc - gh) / abs(gh),
                   "params_max_abs": p_abs, "params_rel": p_rel, "two_lr_sum": moved,
                   "loss": lc, "grad_norm": gc}
            check(row["loss_rel"] <= TRAIN_LOSS_RTOL and row["grad_norm_rel"] <= TRAIN_GNORM_RTOL
                  and row["params_max_abs"] <= moved,
                  f"train (b) {ce} step {i}: card vs CPU {row}")
            steps.append(row)
        vs_cpu[ce] = {"grads_rel": grads_rel, "grads_rtol": grad_rtol, "steps": steps,
                      "cpu_s": cpu_s}
        print(f"train (b) {ce}: {vs_cpu[ce]}", flush=True)
        del card_model, p_card, s_card, st_card, host_model, p_host, s_host, st_host
    out["card_vs_cpu"] = {"layers": 1, "batch": TRAIN_CPU_BATCH, "seq": TRAIN_CPU_SEQ,
                          "loss_rtol": TRAIN_LOSS_RTOL, "grad_norm_rtol": TRAIN_GNORM_RTOL,
                          **vs_cpu}
    torch.cuda.empty_cache()

    out["part_seconds"]["b"] = time.perf_counter() - t_part
    # (e) the coded expert FFN's backward, two of its workers dead
    t_part = time.perf_counter()
    mcfg = dataclasses.replace(configs.get(SERVE_ARCH), num_layers=1)
    plain, coded_model = build(mcfg, dev), build(mcfg.with_opts(["coded_moe"]), dev)
    mp = plain.init(SEED)
    batch = SyntheticCorpus(mcfg, TRAIN_MOE_BATCH, TRAIN_MOE_SEQ, seed=SEED).make_batch(0)
    want_loss, want = value_and_grad(plain, mp, batch)
    surv = np.ones(moe.coded_moe_num_workers(mcfg), dtype=bool)
    surv[list(SERVE_DEAD)] = False
    D = torch.as_tensor(moe.coded_moe_decode_matrix(mcfg, surv), device=dev)
    with moe.coded_moe_decode(D):
        got_loss, got = value_and_grad(coded_model, mp, batch)
        o = opt()
        _, _, met = make_train_step(coded_model, o)(mp, o.init(mp), batch)
    loss_rel = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
    by_leaf = sorted(((_tree_errs({"x": g}, {"x": w})[1], k) for (k, g), (_, w) in zip(
        _flat_items(got), _flat_items(want))), reverse=True)[:3]
    grad_err = by_leaf[0][0]
    step_loss_rel = abs(float(met["loss"]) - float(got_loss)) / abs(float(got_loss))
    check(loss_rel <= TRAIN_CODED_RTOL and grad_err <= TRAIN_CODED_RTOL
          and step_loss_rel <= TRAIN_LOSS_RTOL and math.isfinite(float(met["grad_norm"])),
          f"train (e): coded vs plain loss {loss_rel}, grads {grad_err}, step {step_loss_rel}")
    out["coded_moe_backward"] = {"arch": mcfg.name, "layers": 1, "dead": list(SERVE_DEAD),
                                 "workers": int(surv.size), "tokens": TRAIN_MOE_BATCH
                                 * TRAIN_MOE_SEQ, "loss": float(got_loss),
                                 "loss_rel": loss_rel, "grads_rel": grad_err,
                                 "worst_leaves": [{"leaf": k, "rel": e} for e, k in by_leaf],
                                 "step_loss_rel": step_loss_rel, "rtol": TRAIN_CODED_RTOL}
    del plain, coded_model, mp, want, got, D
    torch.cuda.empty_cache()

    out["part_seconds"]["e"] = time.perf_counter() - t_part
    # (c) the CLI: fail after a checkpoint, resume from it, finish
    t_part = time.perf_counter()
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        rc1, out1, s1 = _train_cli(dev, ckpt, "--simulate-failure", str(TRAIN_CLI_FAIL))
        check(rc1 == 17 and "fresh start" in out1
              and f"SIMULATED FAILURE at step {TRAIN_CLI_FAIL}" in out1,
              f"train (c): the failing run exited {rc1}: {out1[-2000:]}")
        rc2, out2, s2 = _train_cli(dev, ckpt)
        check(rc2 == 0 and "resumed from step 5" in out2 and "done: 7 steps" in out2,
              f"train (c): the resumed run exited {rc2}: {out2[-2000:]}")
        lines = [ln for ln in (out1 + out2).splitlines() if ln.startswith("[train]")]
        out["cli"] = {"args": TRAIN_CLI, "fail_at": TRAIN_CLI_FAIL, "failed_run_s": s1,
                      "resumed_run_s": s2, "lines": lines}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out["part_seconds"]["c"] = time.perf_counter() - t_part
    print(smi, flush=True)
    emit(phase="train", nvidia_smi=smi, seconds=time.perf_counter() - t_phase, **out)


def _flat_items(tree: dict, prefix: str = ""):
    """(path, leaf) of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ------------------------------- phase 8d -----------------------------------
# the four families ported last, at their published widths: rwkv6-3b (32
# layers, d 2560, 40 heads of 64, d_ff 8960; full depth), the mamba mixer
# of jamba-1.5-large-398b alone at its width (d 8192, d_inner 16,384,
# d_state 16, d_conv 4, dt_rank 512; one of its layer groups holds four
# MoE layers of 16 x 3 x 8192 x 24,576, about 155 GB in f32, which no
# card holds) and the whole jamba at reduced(), llama-3.2-vision-11b (40
# layers, d 4096, 32/8 heads, d_ff 14,336, 1601 image tokens; full depth)
# and whisper-medium (24 encoder + 24 decoder layers, d 1024, 1500 frames;
# full depth).  The memories (image tokens, frames) are unit normal stub
# embeddings, as the configs' stubbed front ends leave them.
FAM_RWKV, FAM_JAMBA = "rwkv6-3b", "jamba-1.5-large-398b"
FAM_VLM, FAM_ENCDEC = "llama-3.2-vision-11b", "whisper-medium"
FAM_CPU_SEQ = 128            # tokens of each card-vs-CPU check
FAM_PROMPTS = {FAM_RWKV: 512, FAM_VLM: 256, FAM_ENCDEC: 64}
FAM_NEW_TOKENS = 16
FAM_TRAIN = {FAM_RWKV: (1, 512), FAM_ENCDEC: (2, 256)}  # batch, seq
FAM_TRAIN_STEPS = 3
FAM_MAMBA_PREFILL = 120      # of FAM_CPU_SEQ: the rest decoded one token a step
FAM_SERVE_REQUESTS = 4
FAM_CLI = ["--layers", "2", "--steps", "3", "--batch", "2", "--seq", "128", "--ckpt-every", "0"]
# logits (card vs CPU, cached decode vs one forward) within 1e-4 of the
# reference's max|logit|, and each gradient leaf within 1e-4 of its
# largest magnitude: f32 products summed in other orders (and the scans'
# f32 recurrences), a few layers deep, round near 1e-6 of the scale; bf16
# anywhere would miss by an order of magnitude.  A key bias's gradient is
# 0 in exact arithmetic (the softmax ignores a shift shared by every key):
# it is held within 1e-4 of the tree's largest gradient instead.
FAM_RTOL = 1e-4
# rwkv6-3b at its init is ill-conditioned in f32: at position 0 the scan's
# state is empty and u is small, so a head's output is a sum of 64 terms
# that nearly cancel (its mean square 3e-6 to 1e-4, where other positions
# reach 40), and the per-head normalisation scales that rounding up to the
# output's size; over the layers its f32 forward departs from an f64 one
# by 1.3e-4 of max|logit| at 4 layers on a CPU.  So where the model's f64
# copy fits (FAM_F64_BYTES), its cached decode is held to its forward in
# f64 within FAM_F64_RTOL (f64 rounding, with the same amplification),
# and the f32 decode within FAM_RTOL plus twice the f32 forward's
# distance from the f64 forward, measured on the same tokens in the run.
FAM_F64_RTOL, FAM_F64_BYTES = 1e-9, 30e9


def _memory(cfg, batch: int, dev, seed: int = SEED) -> dict:
    """The family's stub memory as unit normal embeddings: ``vision`` (vlm)
    or ``frames`` (encdec); none for the others."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.family == "vlm":
        return {"vision": torch.randn((batch, cfg.vision_tokens, cfg.d_model),
                                      generator=gen, device=dev)}
    if cfg.family == "encdec":
        return {"frames": torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                      generator=gen, device=dev)}
    return {}


def _prompt(cfg, batch: int, seq: int, dev, seed: int = SEED) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)).to(dev)


def _grad_errs(got: dict, want: dict) -> dict:
    """Each gradient leaf's max|got - want| over its largest magnitude
    (a key bias's over the tree's largest gradient): the worst three."""
    g_items, w_items = list(_flat_items(got)), list(_flat_items(want))
    largest = max(float(w.abs().max()) for _, w in w_items)
    rows = []
    for (k, g), (k2, w) in zip(g_items, w_items, strict=True):
        check(k == k2, f"families: gradient trees differ at {k} / {k2}")
        w = w.float().cpu()
        err = float((g.float().cpu() - w).abs().max())
        scale = largest if k.endswith("/bk") else max(float(w.abs().max()), 1e-30)
        rows.append((err / scale, k))
    return {"worst": [{"leaf": k, "rel": e} for e, k in sorted(rows, reverse=True)[:3]],
            "max_rel": max(e for e, _ in rows), "leaves": len(rows)}


def _cached_vs_forward(model, params, prompt, steps: int, extras: dict, cache_dtype,
                       dev, feed: list | None = None) -> tuple[dict, torch.Tensor]:
    """Prefill ``prompt`` (with the memory), ``steps`` decode steps (greedy,
    or feeding the tokens ``feed``), then one forward over the same
    tokens: the logits' error relative to the forward's max|logit|, the
    tokens, and the prefill's and a decode step's host-clock times (each
    ending in a synchronise); and the forward's logits at the decoded
    positions, on the host."""
    from repro_torch.core.blocks import synchronize

    P = prompt.shape[1]
    with torch.no_grad():
        synchronize(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompt, extras=extras, max_seq=P + steps,
                                      cache_dtype=cache_dtype)
        synchronize(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        out, toks = [logits[:, -1].cpu()], []
        t0 = time.perf_counter()
        for i in range(steps):
            tok = (torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None] if feed is None
                   else torch.tensor([[feed[i]]], dtype=torch.int32, device=prompt.device))
            toks.append(tok)
            logits, cache = model.decode_step(params, cache, tok)
            out.append(logits[:, -1].cpu())
        synchronize(dev)
        decode_ms = (time.perf_counter() - t0) * 1e3 / steps
        states = sorted({str(t.dtype).removeprefix("torch.") for t in _leaves(cache["groups"])})
        del cache
        x, _, _ = model.forward(params, torch.cat([prompt, *toks], 1), extras=extras)
        full = model.logits(params, x[:, P - 1:]).cpu()
    err = _logit_err(torch.stack(out, 1), full)
    return {"prompt": P, "steps": steps, "cache_dtype": str(cache_dtype).removeprefix("torch."),
            "logits_err": err, "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
            "cache_dtypes_after": states, "tokens": torch.cat(toks, 1)[0].tolist()}, full


def _family_vs_cpu(cfg, dev, seq: int, grads: bool) -> dict:
    """``cfg`` (cut in depth) on the card and on the CPU with the same
    weights: the logits of one forward over a ``seq``-token prompt (with
    the memory), and where ``grads`` is set the loss and every gradient
    leaf on a ``SyntheticCorpus`` batch."""
    from repro_torch.models import build
    from repro_torch.training.data import SyntheticCorpus
    from repro_torch.training.train_step import value_and_grad

    card, host = build(cfg, dev), build(cfg, "cpu")
    p_card = card.init(SEED)
    p_host = _tree_to(p_card, "cpu")
    prompt, mem = _prompt(cfg, 1, seq, dev), _memory(cfg, 1, dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        x, _, _ = host.forward(p_host, prompt.cpu(), extras=_tree_to(mem, "cpu"))
        want = host.logits(p_host, x)
        cpu_s = time.perf_counter() - t0
        got = card.logits(p_card, card.forward(p_card, prompt, extras=mem)[0]).cpu()
    out = {"layers": cfg.num_layers, "tokens": seq, "logits_err": _logit_err(got, want)}
    if cfg.encoder_layers:
        out["encoder_layers"] = cfg.encoder_layers
    check(out["logits_err"] <= FAM_RTOL, f"families: {cfg.name} card vs CPU logits {out}")
    if grads:
        batch = SyntheticCorpus(cfg, 1, seq, seed=SEED).make_batch(0)
        t0 = time.perf_counter()
        loss_h, g_host = value_and_grad(host, p_host, batch)
        cpu_s += time.perf_counter() - t0
        loss_c, g_card = value_and_grad(card, p_card, batch)
        out["loss_rel"] = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
        out["grads"] = _grad_errs(g_card, g_host)
        check(out["loss_rel"] <= FAM_RTOL and out["grads"]["max_rel"] <= FAM_RTOL,
              f"families: {cfg.name} card vs CPU loss/gradients {out}")
    out["cpu_s"] = cpu_s
    return out


def _family_train(cfg, dev, batch: int, seq: int) -> dict:
    """``FAM_TRAIN_STEPS`` train steps (AdamW at the CLI's rate) on
    ``SyntheticCorpus`` batches: each step's loss, gradient norm and time,
    tokens/s after the first, peak memory."""
    from repro_torch.core.blocks import synchronize
    from repro_torch.models import build
    from repro_torch.training import AdamW, cosine_warmup_schedule, make_train_step
    from repro_torch.training.data import SyntheticCorpus

    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, dev)
    params = model.init(SEED)
    opt = AdamW(lr=cosine_warmup_schedule(TRAIN_LR, TRAIN_WARMUP, FAM_TRAIN_STEPS))
    state = opt.init(params)
    step = make_train_step(model, opt)
    corpus = SyntheticCorpus(cfg, batch, seq, seed=SEED)
    rows = []
    for i in range(FAM_TRAIN_STEPS):
        b = corpus.make_batch(i)
        synchronize(dev)
        t0 = time.perf_counter()
        params, state, met = step(params, state, b)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        rows.append({"step": i, "loss": loss, "grad_norm": gnorm, "s": time.perf_counter() - t0})
        print(f"families train {cfg.name} step {i}: {rows[-1]}", flush=True)
    ln_v = math.log(cfg.vocab_size)
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows)
          and abs(rows[0]["loss"] - ln_v) <= TRAIN_LOSS0_ATOL
          and all(torch.isfinite(t).all() for t in _leaves(params)),
          f"families: {cfg.name} train steps {rows} (ln V = {ln_v})")
    step_s = statistics.median(r["s"] for r in rows[1:])
    n = sum(t.numel() for t in _leaves(params))
    return {"batch": batch, "seq": seq, "params": n, "steps": rows,
            "step_s_median_after_first": step_s, "tokens_per_s": batch * seq / step_s,
            "peak_allocated_bytes": torch.cuda.max_memory_allocated(), "params_bytes": 4 * n,
            "ln_vocab": ln_v}


def _family_full(cfg, dev, P: int, out: dict) -> None:
    """At full width and depth: ``generate`` (the default bf16 cache) on
    the family's prompt with its memory, then cached decode (f32 cache, and
    a bf16 one for the attention-free family) against one forward over
    the same tokens; each time beside the weights' traffic at 3.35 TB/s.
    ``P``: the prompt's tokens."""
    from repro_torch.core.blocks import synchronize
    from repro_torch.models import build
    from repro_torch.serving import generate
    from repro_torch.training.tree import tree_map

    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, dev)
    params = model.init(SEED)
    n = sum(t.numel() for t in _leaves(params))
    prompt, mem = _prompt(cfg, 1, P, dev), _memory(cfg, 1, dev)
    gen = lambda: generate(model, params, prompt, steps=FAM_NEW_TOKENS,  # noqa: E731
                           max_seq=P + FAM_NEW_TOKENS, extras=mem)
    with torch.no_grad():
        toks = gen()
        synchronize(dev)
        t0 = time.perf_counter()
        toks = gen()
        synchronize(dev)
        gen_s = time.perf_counter() - t0
    check(toks.shape == (1, FAM_NEW_TOKENS), f"families: {cfg.name} generate gave {toks.shape}")
    # a decode step reads every weight but the encoder's and the embedding
    # table's (one row of it): their bytes over the card's memory rate;
    # a prefill does 2 flops a weight a token on top
    read = sum(t.numel() for k, t in _flat_items(params)
               if k != "embed" and not k.startswith("enc"))
    out["params"] = n
    out["decode_weights_bytes"] = 4 * read
    out["weight_traffic_bound_ms"] = 4 * read / HBM_BYTES_PER_S * 1e3
    out["prefill_flop_bound_ms"] = 2 * read * P / F32_FLOP_PER_S * 1e3
    out["generate"] = {"prompt": P, "new_tokens": FAM_NEW_TOKENS, "s": gen_s,
                       "tokens": toks[0].tolist()}
    rows, full = [], None
    for cache_dtype in ((torch.float32, torch.bfloat16) if cfg.rwkv else (torch.float32,)):
        row, f = _cached_vs_forward(model, params, prompt, FAM_NEW_TOKENS, mem, cache_dtype, dev)
        rows.append(row)
        full = f if full is None else full
        print(f"families {cfg.name}: {row} (weights {out['weight_traffic_bound_ms']:.2f} ms)",
              flush=True)
    limit = FAM_RTOL
    if 8 * n <= FAM_F64_BYTES:
        # the same decode and forward in f64 (feeding the f32 run's tokens):
        # they agree to f64 rounding, and the f32 forward's distance from
        # the f64 one is what f32 rounding does to this model's logits; two
        # f32 evaluations may be twice that apart
        p64 = tree_map(torch.Tensor.double, params)
        del params
        torch.cuda.empty_cache()
        exact, full64 = _cached_vs_forward(model, p64, prompt, FAM_NEW_TOKENS,
                                           {k: v.double() for k, v in mem.items()},
                                           torch.float64, dev, feed=rows[0]["tokens"])
        f32_err = _logit_err(full.double(), full64)
        limit = FAM_RTOL + 2 * f32_err
        out["f64"] = {"cached_vs_forward_err": exact["logits_err"], "rtol": FAM_F64_RTOL,
                      "f32_forward_vs_f64": f32_err, "prefill_ms": exact["prefill_ms"],
                      "decode_ms_per_token": exact["decode_ms_per_token"]}
        check(exact["logits_err"] <= FAM_F64_RTOL,
              f"families: {cfg.name} f64 cached decode vs forward {out['f64']}")
        del p64
    for row in rows:
        row["limit"] = limit
        check(row["logits_err"] <= limit, f"families: {cfg.name} cached decode vs forward "
                                          f"{row} (limit {limit})")
    out["cached_vs_forward"] = rows
    out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    del model
    torch.cuda.empty_cache()


def _mamba_mixer(cfg, dev) -> dict:
    """The mamba mixer alone at ``cfg``'s width: forward and every
    gradient (a fixed random cotangent) on the card against the CPU, and
    the state-carrying decode against the forward."""
    from repro_torch.models import ssm
    from repro_torch.models.layers import tree_init

    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = tree_init(ssm.mamba_defs(cfg), gen, torch.float32, dev)
    for k in ("A_log", "dt_bias", "conv_b", "D"):  # zeros and ones at init: make them count
        p[k] = p[k] + 0.1 * torch.randn(p[k].shape, generator=gen, device=dev)
    x = torch.randn((1, FAM_CPU_SEQ, cfg.d_model), generator=gen, device=dev)
    cot = torch.randn((1, FAM_CPU_SEQ, cfg.d_model), generator=gen, device=dev)

    def run(p_, x_, cot_):
        live = {k: v.detach().requires_grad_() for k, v in p_.items()}
        xin = x_.detach().requires_grad_()
        y, _ = ssm.mamba_apply(xin, live, cfg)
        grads = torch.autograd.grad((y * cot_).sum(), [xin, *live.values()])
        return y.detach(), dict(zip(["x", *live], grads))

    y_c, g_c = run(p, x, cot)
    t0 = time.perf_counter()
    y_h, g_h = run(_tree_to(p, "cpu"), x.cpu(), cot.cpu())
    cpu_s = time.perf_counter() - t0
    di, dt_rank, ds, dc = ssm._dims(cfg)
    out = {"d_model": cfg.d_model, "d_inner": di, "d_state": ds, "d_conv": dc,
           "dt_rank": dt_rank, "tokens": FAM_CPU_SEQ, "cpu_s": cpu_s,
           "out_err": _logit_err(y_c.cpu(), y_h), "grads": _grad_errs(g_c, g_h)}
    with torch.no_grad():
        state = ssm.mamba_init_state(cfg, 1, torch.float32, dev)
        ys, state = ssm.mamba_apply(x[:, :FAM_MAMBA_PREFILL], p, cfg, state=state)
        steps = [ys]
        for t in range(FAM_MAMBA_PREFILL, FAM_CPU_SEQ):
            y_t, state = ssm.mamba_apply(x[:, t:t + 1], p, cfg, state=state)
            steps.append(y_t)
    out["decode_vs_forward_err"] = _logit_err(torch.cat(steps, 1).cpu(), y_c.cpu())
    out["decoded_steps"] = FAM_CPU_SEQ - FAM_MAMBA_PREFILL
    check(out["out_err"] <= FAM_RTOL and out["grads"]["max_rel"] <= FAM_RTOL
          and out["decode_vs_forward_err"] <= FAM_RTOL, f"families: mamba mixer {out}")
    return out


def _jamba_reduced(dev) -> dict:
    """The whole jamba at reduced() on the card against the CPU: forward
    logits, cached decode, loss and gradients, and ``ServingEngine``
    (coded expert jobs, worker 0 dead) with the CPU's outcomes."""
    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.serving import ServingEngine, TenantSpec, poisson_trace

    cfg = configs.get(FAM_JAMBA).reduced()
    out = {"reduced": _family_vs_cpu(cfg, dev, 16, grads=True)}
    params = build(cfg, dev).init(SEED)
    rows = {}
    for name, where, p in (("card", dev, params), ("cpu", torch.device("cpu"),
                                                   _tree_to(params, "cpu"))):
        row, _ = _cached_vs_forward(build(cfg, where), p, _prompt(cfg, 2, 8, where), 4, {},
                                    torch.float32, where)
        check(row["logits_err"] <= FAM_RTOL, f"families: reduced jamba {name} decode {row}")
        rows[name] = row
    check(rows["card"]["tokens"] == rows["cpu"]["tokens"], f"families: reduced jamba {rows}")
    out["cached_vs_forward"] = rows
    trace = lambda: poisson_trace([TenantSpec("a", rate=60.0, prompt_len=5,  # noqa: E731
                                              max_new_tokens=4)],
                                  horizon=0.1, seed=9, max_requests=FAM_SERVE_REQUESTS)
    served = {}
    for name, where, p in (("card", dev, params), ("cpu", "cpu", _tree_to(params, "cpu"))):
        with ServingEngine(cfg, coded=True, num_workers=6, source="sim", dead_workers=(0,),
                           unit_block_time=1e-3, max_batch=2, max_seq=16, device=where,
                           params=p) as eng:
            m = eng.run(trace())
        served[name] = sorted((r.rid, r.tokens, r.completed, r.error, r.straggler_recoveries)
                              for r in m.requests)
    s = served["card"]
    check(s == served["cpu"] and all(r[2] for r in s) and all(r[4] >= 1 for r in s),
          f"families: reduced jamba engine card {s} vs CPU {served['cpu']}")
    out["engine"] = {"requests": len(s), "dead_workers": [0],
                     "outcomes": [{"rid": r[0], "tokens": r[1], "recoveries": r[4]} for r in s]}
    return out


def phase_families(smi: str, dev: torch.device) -> None:
    """The rwkv, hybrid (mamba), vlm (cross-attention) and encdec (encoder)
    families on the card.  rwkv6-3b: one layer card vs CPU (logits and
    gradients), ``generate``, cached decode vs forward at f32 and bf16
    caches, train steps at full depth.  jamba: the mamba mixer at full
    width card vs CPU with gradients and its decode vs its forward; the
    whole model at reduced() card vs CPU, and served.
    llama-3.2-vision-11b: one layer group card vs CPU, ``generate`` with
    image tokens, cached decode vs forward.  whisper-medium: one encoder
    and one decoder layer card vs CPU with gradients, ``generate`` with
    frames, cached decode vs forward, train steps at full depth, the
    training CLI two decoder layers deep.  None launches a kernel of the
    table: the scans are loops of torch operations over time."""
    import shutil
    import tempfile

    from repro_torch import configs

    t_phase = time.perf_counter()
    out: dict = {"part_seconds": {}}

    def part(name: str, fn) -> None:
        t0 = time.perf_counter()
        out[name] = fn()
        out["part_seconds"][name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        print(f"families {name}: {out['part_seconds'][name]:.1f} s", flush=True)

    def full(name):
        row = {}
        _family_full(configs.get(name), dev, FAM_PROMPTS[name], row)
        return row

    rwkv, vlm, encdec = (configs.get(n) for n in (FAM_RWKV, FAM_VLM, FAM_ENCDEC))
    part("rwkv_vs_cpu", lambda: _family_vs_cpu(dataclasses.replace(rwkv, num_layers=1), dev,
                                               FAM_CPU_SEQ, grads=True))
    part("rwkv", lambda: full(FAM_RWKV))
    part("rwkv_train", lambda: _family_train(rwkv, dev, *FAM_TRAIN[FAM_RWKV]))
    part("mamba_mixer", lambda: _mamba_mixer(configs.get(FAM_JAMBA), dev))
    part("jamba_reduced", lambda: _jamba_reduced(dev))
    part("vlm_vs_cpu", lambda: _family_vs_cpu(
        dataclasses.replace(vlm, num_layers=vlm.group_size), dev, FAM_CPU_SEQ // 2, grads=False))
    part("vlm", lambda: full(FAM_VLM))
    part("encdec_vs_cpu", lambda: _family_vs_cpu(
        dataclasses.replace(encdec, num_layers=1, encoder_layers=1), dev, FAM_CPU_SEQ,
        grads=True))
    part("encdec", lambda: full(FAM_ENCDEC))
    part("encdec_train", lambda: _family_train(encdec, dev, *FAM_TRAIN[FAM_ENCDEC]))

    def cli():
        import os

        ckpt = tempfile.mkdtemp(prefix="chip_smoke_families_")
        try:
            cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", FAM_ENCDEC,
                   *FAM_CLI, "--ckpt-dir", ckpt,
                   *([] if dev.type == "cuda" else ["--device", "cpu"])]
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
            proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                                  timeout=TRAIN_CLI_TIMEOUT_S)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        text = proc.stdout + proc.stderr
        check(proc.returncode == 0 and "done: 3 steps" in text,
              f"families: the whisper CLI exited {proc.returncode}: {text[-2000:]}")
        return {"args": FAM_CLI, "lines": [ln for ln in text.splitlines()
                                           if ln.startswith("[train]")]}

    part("encdec_cli", cli)
    out["limits"] = {"rtol": FAM_RTOL, "loss0_atol": TRAIN_LOSS0_ATOL}
    out["reduced"] = {FAM_JAMBA: "the mamba mixer alone at full width; the model at reduced()",
                      FAM_VLM: f"card vs CPU at {vlm.group_size} of {vlm.num_layers} layers",
                      FAM_ENCDEC: "card vs CPU at 1 + 1 layers; the CLI at 2 decoder layers",
                      FAM_RWKV: "card vs CPU at 1 of 32 layers"}
    print(smi, flush=True)
    emit(phase="families", nvidia_smi=smi, seconds=time.perf_counter() - t_phase, **out)


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


# ------------------------------- phase 11 -----------------------------------

LAUNCH_ARCH = "internlm2-1.8b"
# the dry run's cells held to the card's allocator: internlm2-1.8b at full
# width and depth on the one-device mesh, a train step and a decode token
LAUNCH_CELLS = {"card_train": dict(seq=512, batch=4, kind="train"),
                "card_decode": dict(seq=4096, batch=4, kind="decode")}
LAUNCH_MESH = {"data": 1, "model": 1}
# the arguments' bytes on the card against the dry run's exact arithmetic:
# 0.5% plus 1 MiB (the allocator rounds each tensor up to 512 bytes)
LAUNCH_ARG_RTOL, LAUNCH_ARG_SLACK = 5e-3, 1 << 20
# the peak's predicted band around the dry run's estimate (PERF.md section 6),
# printed beside it, not checked: the card adds what the meta run cannot
# see (cuBLAS workspaces, a kernel's own scratch)
LAUNCH_PEAK_BAND = {"card_train": (-0.01, 0.03), "card_decode": (-0.01, 0.0)}
LAUNCH_PEAK_SLACK = 64 << 20


def _on_card(tree, kind: str, dev: torch.device, vocab: int):
    """A meta argument tree made on the card in its shapes and dtypes:
    parameters drawn N(0, 0.02^2), token ids in [0, vocab), the rest
    (optimizer state, cache) zeros; the cache's host ``pos`` kept."""
    from repro_torch.launch import dryrun

    def leaf(_, t):
        if not isinstance(t, torch.Tensor):
            return t
        out = torch.zeros(t.shape, dtype=t.dtype, device=dev)
        if kind == "params":
            out.normal_(0.0, 0.02)
        elif kind == "batch":
            out.random_(0, vocab)
        return out

    return dryrun._map(leaf, tree)


def _descendants() -> dict[int, str]:
    """This process's live descendants, pid -> command line, from /proc (a
    zombie, which goes with its parent, is left out)."""
    children, cmd = {}, {}
    for entry in pathlib.Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
            argv = (entry / "cmdline").read_bytes()
        except OSError:  # ended while being read
            continue
        state, ppid = stat.rsplit(")", 1)[1].split()[:2]
        if state != "Z":
            children.setdefault(int(ppid), []).append(int(entry.name))
            cmd[int(entry.name)] = argv.replace(b"\0", b" ").decode(errors="replace")[:120]
    out, todo = {}, [os.getpid()]
    while todo:
        for pid in children.get(todo.pop(), []):
            out[pid] = cmd[pid]
            todo.append(pid)
    return out


def phase_stop_workers() -> None:
    """The worker pools are done: stop their fork server and the resource
    tracker, and check that every process they started has ended (one
    that outlives the script would be forked from the server, not from this
    process, so the pids are taken before the server stops)."""
    from repro_torch.runtime import procpool

    before = _descendants()
    procpool.stop_fork_server()
    deadline = time.perf_counter() + 10.0
    while time.perf_counter() < deadline and any(
            pathlib.Path(f"/proc/{pid}").exists() for pid in before):
        time.sleep(0.05)
    left = {pid: c for pid, c in before.items() if pathlib.Path(f"/proc/{pid}").exists()}
    check(not left and not _descendants(),
          f"processes left after the pools: {left or _descendants()}")
    emit(phase="stop_workers", stopped=sorted(before.values()))


def phase_launch(dev: torch.device, row1: dict) -> None:
    """The launch tooling on the card: the data sheet's peaks and the
    card's own (calibrated), the JAX package's kernel roofline of row 1's
    heaviest launch (added to that row), the dry run's byte account held
    to the card's allocator on the two cells, and one full-size roofline
    analysis on meta.  No kernel of the table is launched."""
    from repro_torch import configs
    from repro_torch.launch import dryrun, meshctx, roofline

    t_phase = time.perf_counter()
    sheet = roofline.machine_peaks()
    measured = roofline.machine_peaks(calibrate=True)
    emit(phase="launch", peaks={"default": sheet, "calibrated": measured,
                                "datasheet_hbm_bytes_per_s": HBM_BYTES_PER_S})

    shape = row1["shape"]
    cost = roofline.fused_kernel_cost(live_tiles=shape["live_slots"], bs=shape["bs"],
                                      bt=shape["bt"], mn=shape["mn"],
                                      br=shape["CB"] * shape["bs"], fused=True)
    row1["reference_roofline"] = {
        "cost": cost, "measured_ms": row1["ms"],
        "fraction_datasheet": roofline.roofline_fraction(
            cost, row1["ms"] / 1e3, roofline.machine_peaks(calibrate=False)),
        "fraction_calibrated": roofline.roofline_fraction(cost, row1["ms"] / 1e3, measured),
        "note": "gathered B counted once per live slot (roofline.fused_kernel_cost)"}
    emit(phase="launch", kernel=row1["name"], **row1["reference_roofline"])

    cfg = configs.get(LAUNCH_ARCH)
    dryrun.SHAPES.update(LAUNCH_CELLS)
    cells = {}
    for name in LAUNCH_CELLS:
        rec = dryrun.run_cell(LAUNCH_ARCH, name, False, mesh=LAUNCH_MESH)
        check(rec["status"] == "ok", f"launch {name}: the dry run says {rec}")
        ma = rec["memory_analysis"]
        with meshctx.use_mesh(LAUNCH_MESH):
            step, meta_args, _, kinds = dryrun.build_cell(cfg, name, LAUNCH_MESH, device=dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        args = [_on_card(a, kind, dev, cfg.vocab_size) for a, kind in zip(meta_args, kinds)]
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - base
        arg_tol = LAUNCH_ARG_RTOL * ma["argument_bytes"] + LAUNCH_ARG_SLACK
        check(abs(grown - ma["argument_bytes"]) <= arg_tol,
              f"launch {name}: the arguments took {grown} bytes on the card, "
              f"the dry run says {ma['argument_bytes']} (+- {arg_tol})")
        torch.cuda.reset_peak_memory_stats()
        step_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() - base
        if LAUNCH_CELLS[name]["kind"] == "train":
            loss = float(out[2]["loss"])
            check(math.isfinite(loss), f"launch {name}: loss {loss}")
            result = {"loss": loss}
        else:
            tokens = out[0]
            check(tokens.shape == (LAUNCH_CELLS[name]["batch"],)
                  and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
                  f"launch {name}: decoded {tokens}")
            result = {"tokens": tokens.tolist()}
        del out, args
        torch.cuda.empty_cache()
        lo, hi = LAUNCH_PEAK_BAND[name]
        est = ma["peak_bytes_est"]
        cells[name] = {
            "argument_bytes": ma["argument_bytes"], "card_argument_bytes": grown,
            "argument_tol": arg_tol, "by_kind": rec["argument_bytes_by_kind"],
            "peak_bytes_est": est, "card_peak_bytes": peak,
            "card_over_est": peak / est,
            "band": [est * (1 + lo), est * (1 + hi) + LAUNCH_PEAK_SLACK],
            "in_band": est * (1 + lo) <= peak <= est * (1 + hi) + LAUNCH_PEAK_SLACK,
            "temp_bytes": ma["temp_bytes"], "flops": rec["cost_analysis"]["flops_per_device"],
            "meta_s": rec["meta_s"], "step_s": step_s, **result}
        emit(phase="launch", cell=name, arch=LAUNCH_ARCH, mesh=LAUNCH_MESH,
             **LAUNCH_CELLS[name], **cells[name])

    t0 = time.perf_counter()
    analysis = roofline.analyze_cell(LAUNCH_ARCH, "train_4k")
    check(analysis["status"] == "ok", f"launch analyze_cell: {analysis}")
    emit(phase="launch", analysis={k: analysis[k] for k in (
        "arch", "shape", "chips", "terms", "dominant", "useful_ratio",
        "roofline_fraction_bound", "n_params", "meta_s")},
         analysis_s=time.perf_counter() - t0, seconds=time.perf_counter() - t_phase)


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

    seconds = {}  # each phase's wall seconds, printed before the results

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = round(time.perf_counter() - t0, 2)
        return out

    dev = torch.device("cuda", 0)
    info = timed("device", phase_device)
    built = timed("build", phase_build)
    timed("kernels", lambda: (phase_kernels(), phase_entry_kernels(), phase_accum_tiles()))
    kernels, full = timed("main_path", lambda: phase_main(built))
    kernels += timed("entry_points", lambda: phase_entry_full(full, built))
    by_path = {"device_job": timed("device_job", lambda: phase_device_job(full))}
    _, by_path["schemes"] = timed("schemes", lambda: _counted(lambda: phase_schemes(full)))
    paper = timed("straggler_job", lambda: phase_straggler_job(full, dev))
    del full
    torch.cuda.empty_cache()
    timed("live_job", lambda: phase_live_job(paper))
    for name, phase in (("serving", phase_serving), ("train", phase_train),
                        ("families", phase_families)):
        _, by_path[name] = timed(name, lambda: _counted(
            lambda: phase(info["nvidia_smi"], dev)))
        torch.cuda.empty_cache()
    _, by_path["proc_job"] = timed("proc_job", lambda: _counted(lambda: phase_proc_job(paper)))
    _, by_path["proc_mux"] = timed("proc_mux", lambda: _counted(lambda: phase_proc_mux(paper)))
    timed("stop_workers", phase_stop_workers)
    del paper
    torch.cuda.empty_cache()
    _, by_path["launch"] = timed("launch", lambda: _counted(
        lambda: phase_launch(dev, kernels[0])))
    emit(phase="seconds", **seconds, total=round(sum(seconds.values()), 2))
    check(not _descendants(), f"processes still running: {_descendants()}")
    for path in ("schemes", "serving", "train", "families", "proc_job",
                 "proc_mux", "launch"):  # they run none of the kernels
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
