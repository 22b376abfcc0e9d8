"""The device mesh as it is meant to run: nccl, one card a rank, four cards.

    python3 chip_mesh.py  # on a host with four cards

With fewer than 4 CUDA cards it exits 2 before it starts a rank.  It prints
each card's ``nvidia-smi --query-gpu=name,power.limit`` line, then one JSON
line a part, each checked:

1. ``bandwidth``: ``all_reduce`` and ``all_gather_into_tensor`` over the 4
   cards at 256 MiB and 1 GiB (f32): the median of 5 timed calls after one
   warm-up, as algorithm and bus bandwidth (nccl-tests' definitions:
   all_reduce moves 2 (n-1)/n of its bytes over each link, all_gather
   (n-1)/n of its output).
2. ``coded``: the worker group as it is meant to run -- one nccl rank a
   card, one coded worker a rank, the counterpart of the reference's
   ``shard_map`` over N devices: the main path's operands
   (``chip_smoke.main_operands``: 16384 x 8192 by 16384 x 8192, 8 x 8
   tiles at 10% density) under a ``sparse_code`` plan of 4 workers, m = 2,
   n = 1, in five configurations in one launch of the ranks (replicated
   with 0, 1 and 2 workers dead, ``out_sharded`` -- its ``reduce_scatter``
   pads the 2 blocks to 4 -- with 0 and 1 dead; the dead drawn as the
   reference's ``_kill_masks`` draws them).  Each: C within GROUP_RTOL of
   max|C| of the one-process apply of the same plan and mask on card 0
   and within 1e-3 of the dense f32 A^T B, one fused-decode launch a rank
   an apply; every rank's kernel, collective and apply ms, the bytes its
   collective moved and its card's peak memory.
3. ``lm``: internlm2-1.8b at full width and depth on {data 2, model 2},
   batch 4 x 512 (the train phase's cell), 5 steps: each rank's step
   times, tokens/s and peak memory; step 0's loss against the one-process
   step on card 0 (within 1e-5 relative).
4. ``restart``: the CLI at full width, depth cut to 1 layer (the
   checkpoints' size): 4 cards fail at step 8, ``--elastic`` resumes on 2
   cards ({data 1, model 2}) from step 5; the losses against an
   uninterrupted one-process run (within 2e-4; 4 decimals printed).
5. ``moe``: qwen3-moe-30b-a3b at full width, 4 of 48 layers (the serving
   phase's depth), batch 2 x 256, in the MoE forms of chip_smoke.py's
   ``mesh`` phase, each timed and held as there; then the local dispatch
   with and without the shard_map combine at 3 x 256, a batch the 2 dp
   shards do not divide (the tokens replicated over "data", each rank
   slicing its chunk of 384), held the same way.
6. ``families``: rwkv6-3b, llama-3.2-vision-11b and whisper-medium at
   full width, cut to one layer group (whisper: one decoder and one
   encoder layer), and jamba-1.5-large-398b as chip_smoke.py's
   ``families`` phase runs it -- its Mamba mixer alone at full width, the
   whole model at reduced().  Each: a train step at batch 4 x 256, its
   loss within 1e-5 relative and every gathered gradient within 1e-4 of
   its leaf's largest against the one-process port on card 0; a prefill
   of 4 x 128 and 8 greedy decode tokens with the cache placed (f32), the
   tokens equal to one process's and the logits within 1e-4 of
   max|logit|; the step's seconds, the prefill's ms, a decode step's ms
   on each rank and each card's peak memory.
7. ``dryrun``: internlm2-1.8b's train cell at the ``lm`` part's size (4 x
   512, full depth) and one decode cell a family at ``families``' sizes
   (4 sequences, a cache of 136), each dry-run on a fake {data 2, model 2}
   mesh in a host process of its own (beside the ranks) and run on the
   four cards on arguments made there in the shards' shapes: the
   collectives' counts and bytes, kind by kind, equal to what rank 0
   issues (backward included); the arguments' bytes within 0.5% + 1 MiB
   of each rank's allocator; each rank's ``max_memory_allocated`` within
   DRY_PEAK_BAND of the peak estimate.  The cards' garbage is collected
   before each cell's base is read (a train step's graph is freed by
   Python's cycle collector, and freed inside the next cell's step it
   would hide that step's peak); the bytes it freed are printed.

``bandwidth`` also prints the roofline's ``collective_s`` for each
measured size (``launch.mesh.ICI_BW``, NVLink 4's data sheet rate) beside
the measured time.  ``python3 chip_mesh.py [part ...]`` runs those parts
only (default: all).  The last line is ``{"ok": true, ...}``.  The
rank-side measurements are ``chip_smoke``'s (``mesh_lm``, ``mesh_forms``,
``mesh_decode``).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from chip_smoke import _cli_losses, emit

ROOT = pathlib.Path(__file__).resolve().parent
CARDS = 4
MESH = {"data": 2, "model": 2}
TIMEOUT_S = 600.0
BW_SIZES = (256 << 20, 1 << 30)
BW_REPEATS = 5
LM_ARCH, LM_BATCH, LM_SEQ, LM_STEPS = "internlm2-1.8b", 4, 512, 5
MOE_ARCH, MOE_LAYERS, MOE_BATCH, MOE_SEQ = "qwen3-moe-30b-a3b", 4, 2, 256
RESTART_CLI = ["--arch", "internlm2-1.8b", "--layers", "1", "--steps", "12", "--batch", "2",
               "--seq", "256", "--ckpt-every", "5", "--opt-dtype", "bfloat16"]
RESTART_FAIL, RESTART_ATOL = 8, 2e-4
PARTS = ("bandwidth", "coded", "lm", "restart", "moe", "families", "dryrun")
# coded: a sparse_code plan of one worker a card, m x n blocks
CODED_M, CODED_N, CODED_REPEATS = 2, 1, 3
# moe: the local dispatch's two forms on a batch the dp shards do not divide
MOE_PAD_BATCH = 3
MOE_PAD_FORMS = {"local": ("moe_local_dispatch",),
                 "shardmap": ("moe_local_dispatch", "moe_shardmap_combine")}
# families: each cut to one layer group (whisper also to one encoder layer)
FAMILIES = {"rwkv6-3b": {}, "llama-3.2-vision-11b": {}, "whisper-medium": {"encoder_layers": 1}}
FAM_JAMBA = "jamba-1.5-large-398b"
FAM_BATCH, FAM_SEQ = 4, 256
DEC_BATCH, DEC_PROMPT, DEC_NEW = 4, 128, 8
FAM_LOSS_RTOL, FAM_GRAD_RTOL, FAM_LOGIT_RTOL = 1e-5, 1e-4, 1e-4
FAM_TIMEOUT_S = 1500.0  # five models, each one process on card 0 then sharded
# dryrun: name -> (arch, cell shape, config change: "reduced" or fields)
DRY_CELLS = {
    "lm_train": ("internlm2-1.8b", dict(seq=LM_SEQ, batch=LM_BATCH, kind="train"), {}),
    **{f"{arch}_decode": (arch, dict(seq=DEC_PROMPT + DEC_NEW, batch=DEC_BATCH, kind="decode"),
                          {"group": True, **kw}) for arch, kw in FAMILIES.items()},
    "jamba_decode": (FAM_JAMBA, dict(seq=DEC_PROMPT + DEC_NEW, batch=DEC_BATCH, kind="decode"),
                     "reduced")}
# the arguments on the card against the dry run's arithmetic, as chip_smoke.py's launch
DRY_ARG_RTOL, DRY_ARG_SLACK = 5e-3, 1 << 20
# a card's peak (max_memory_allocated, the arguments included) over the
# dry run's peak_bytes_est
DRY_PEAK_BAND = (0.95, 1.05)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_mesh: FAILED: {what}")


def _smi() -> list[str]:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()


def _dry_cfg(arch: str, change):
    """A ``DRY_CELLS`` config: "reduced", or the arch cut to one layer group
    (``group``) with the other fields replaced."""
    import repro_torch.configs as configs

    cfg = configs.get(arch)
    if change == "reduced":
        return cfg.reduced()
    change = dict(change)
    if change.pop("group", False):
        change["num_layers"] = cfg.group_size
    return dataclasses.replace(cfg, **change)


def _family_cfg(arch: str):
    return _dry_cfg(arch, {"group": True, **FAMILIES[arch]})


class _MambaBlock:
    """The Mamba mixer alone as a model for ``value_and_grad``: loss = the
    mean square of its output over ``{"p": its parameters, "x": its
    input}`` (a positive sum, so its relative error is well conditioned)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def loss(self, params, batch):
        from repro_torch.models.ssm import mamba_apply

        out, _ = mamba_apply(params["x"], params["p"], self.cfg)
        return out.square().mean()


def _block_vs_one(dev, dmesh, block, params: dict, specs: dict, batch: dict) -> dict:
    """``block``'s loss and every gathered gradient on the mesh against one
    process on rank 0's card, and the sharded call's seconds."""
    from chip_smoke import _leaf_errs, _synced_s
    from repro_torch.launch import meshctx
    from repro_torch.training.data import distribute_batch
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import tree_leaves

    rank0 = dmesh.get_rank() == 0
    want = None
    if rank0:
        loss1, g1 = value_and_grad(block, params, distribute_batch(batch, None, dev))
        want = (float(loss1), tree_leaves(g1))
    with meshctx.use_mesh(dmesh):
        sharded = meshctx.distribute(params, specs, dmesh)
        placed = distribute_batch(batch, dmesh, dev)
        (loss, g), seconds = _synced_s(lambda: value_and_grad(block, sharded, placed), dev)
        errs = []
        for i, leaf in enumerate(tree_leaves(g)):
            full = leaf.full_tensor()
            if rank0:
                errs.extend(_leaf_errs([full], [want[1][i]]))
    out = {"loss": float(loss), "fwd_bwd_s": seconds}
    if rank0:
        out.update(loss_rel_err=abs(float(loss) - want[0]) / abs(want[0]),
                   grad_rel_err=max(errs))
    return out


def _families_rank(dev: torch.device, dmesh) -> dict:
    """Each family's train step and cached decode on the mesh against one
    process, and jamba's Mamba mixer at full width."""
    import repro_torch.configs as configs
    from chip_smoke import SEED, mesh_decode, mesh_lm
    from repro_torch.models import ssm
    from repro_torch.models.layers import tree_init, tree_specs

    out = {}
    cfgs = {arch: _family_cfg(arch) for arch in FAMILIES}
    cfgs[f"{FAM_JAMBA} reduced()"] = configs.get(FAM_JAMBA).reduced()
    for name, cfg in cfgs.items():
        out[name] = {"train": mesh_lm(dev, dmesh, cfg, FAM_BATCH, FAM_SEQ, 1, grads=True)}
        torch.cuda.empty_cache()
        out[name]["decode"] = mesh_decode(dev, dmesh, cfg, DEC_BATCH, DEC_PROMPT, DEC_NEW)
        torch.cuda.empty_cache()
    cfg = configs.get(FAM_JAMBA)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = {"p": tree_init(ssm.mamba_defs(cfg), gen, torch.float32, dev),
              "x": torch.randn(FAM_BATCH, FAM_SEQ, cfg.d_model, generator=gen, device=dev)}
    specs = {"p": tree_specs(ssm.mamba_defs(cfg)), "x": ("dp", None, None)}
    torch.cuda.reset_peak_memory_stats(dev)
    out[f"{FAM_JAMBA} mamba mixer"] = {
        "train": _block_vs_one(dev, dmesh, _MambaBlock(cfg), params, specs, {}),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    return out


_FAKE_CELL = """
import json, sys
sys.path.insert(0, "src")
import chip_mesh
from repro_torch.launch import dryrun
name = sys.argv[1]
arch, info, change = chip_mesh.DRY_CELLS[name]
dryrun.SHAPES[name] = info
rec = dryrun.run_cell(arch, name, False, cfg_override=chip_mesh._dry_cfg(arch, change),
                      mesh=chip_mesh.MESH, probes=False)
print(json.dumps(rec))
"""


def _dry_rank(dev: torch.device, dmesh) -> dict:
    """Each ``DRY_CELLS`` cell's step run on the cards: its arguments made
    in the shards' shapes (the allocator's growth), then the step under the
    collective capture, with its peak and seconds."""
    from repro_torch.launch import dryrun, meshctx

    out = {}
    for name, (arch, info, change) in DRY_CELLS.items():
        dryrun.SHAPES[name] = info
        cfg = _dry_cfg(arch, change)
        with meshctx.use_mesh(MESH):
            step, args, specs, kinds = dryrun.build_cell(cfg, name, MESH, device=dev)
        kind_of = {id(t): k for tree, k in zip(args, kinds) for t in dryrun._leaves(tree)}
        gen = torch.Generator(device=dev).manual_seed(7)

        def make(shape, leaf, _path):
            t = torch.zeros(shape, dtype=leaf.dtype, device=dev)
            if kind_of.get(id(leaf)) == "params":
                t.normal_(0.0, 0.02, generator=gen)
            elif kind_of.get(id(leaf)) == "batch":
                t.random_(0, cfg.vocab_size, generator=gen)
            return t

        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        gc.collect()  # the last cell's cycles go now, not inside this step
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        with meshctx.use_mesh(dmesh):
            placed = dryrun.place(args, specs, dmesh, make=make)
            torch.cuda.synchronize(dev)
            grown = torch.cuda.memory_allocated(dev) - base
            torch.cuda.reset_peak_memory_stats(dev)  # the peak from here holds the arguments
            t0 = time.perf_counter()
            with meshctx.Collectives() as coll:
                res = step(*placed)
            torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
        out[name] = {"card_argument_bytes": grown, "collectives": coll.summary(),
                     "card_peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
                     "gc_freed_bytes": held - base, "step_s": seconds}
        del placed, res
        torch.cuda.empty_cache()
    return out


def _bandwidth_rank(dev: torch.device, dmesh) -> dict:
    """Each collective's median seconds at each size on the world group."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import ICI_BW

    n = dist.get_world_size()
    out = {}
    for size in BW_SIZES:
        for op in ("all_reduce", "all_gather_into_tensor"):
            if op == "all_reduce":
                buf = torch.ones(size // 4, device=dev)

                def call():
                    dist.all_reduce(buf)
            else:
                src = torch.ones(size // 4 // n, device=dev)
                buf = torch.empty(size // 4, device=dev)

                def call():
                    dist.all_gather_into_tensor(buf, src)
            times = []
            for i in range(1 + BW_REPEATS):
                dist.barrier()
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize(dev)
                if i:
                    times.append(time.perf_counter() - t0)
            t = statistics.median(times)
            factor = 2 * (n - 1) / n if op == "all_reduce" else (n - 1) / n
            # the roofline's term for the same collective: its output bytes,
            # an all-reduce's twice, over NVLink's data sheet rate
            priced = (2 if op == "all_reduce" else 1) * size / ICI_BW
            out[f"{op}/{size >> 20}MiB"] = {"bytes": size, "median_s": t,
                                            "algbw_GBps": size / t / 1e9,
                                            "busbw_GBps": size / t / 1e9 * factor,
                                            "roofline_collective_s": priced,
                                            "ici_bw_GBps": ICI_BW / 1e9}
            del buf
    return out


def _lm_rank(dev: torch.device, dmesh) -> dict:
    import repro_torch.configs as configs
    from chip_smoke import mesh_lm

    return mesh_lm(dev, dmesh, configs.get(LM_ARCH), LM_BATCH, LM_SEQ, LM_STEPS, grads=False)


def _moe_rank(dev: torch.device, dmesh) -> dict:
    """chip_smoke's MoE forms at MOE_BATCH, then the local dispatch's two
    forms at MOE_PAD_BATCH (rows named "<form> <B>x<S>")."""
    import repro_torch.configs as configs
    from chip_smoke import SEED, mesh_forms
    from repro_torch.models import build
    from repro_torch.training.data import SyntheticCorpus

    cfg = dataclasses.replace(configs.get(MOE_ARCH), num_layers=MOE_LAYERS)
    model = build(cfg, dev)
    params = model.init(SEED)

    def forms(batch: int, **kw) -> dict:
        tokens = SyntheticCorpus(cfg, batch, MOE_SEQ, seed=SEED).make_batch(0)
        return mesh_forms(dev, dmesh, lambda opts: build(cfg.with_opts(opts), dev),
                          params, model.specs(), tokens, **kw)

    out = forms(MOE_BATCH)
    pad = forms(MOE_PAD_BATCH, forms=MOE_PAD_FORMS)
    return {**out, **{f"{form} {MOE_PAD_BATCH}x{MOE_SEQ}": row for form, row in pad.items()}}


def _cli(ckpt: str, *extra: str) -> tuple[int, str, float]:
    from chip_smoke import _train_cli

    return _train_cli(torch.device("cuda"), ckpt, *extra, base=RESTART_CLI, timeout=TIMEOUT_S)


def _kill_masks(plan, dead_counts=(1, 2)) -> dict:
    """One survivor mask a dead count, drawn as the reference's
    ``tests/spmd_coded_matmul_check.py::_kill_masks`` draws it: the dead
    chosen from a generator seeded 0, a draw kept only where the
    survivors' rows of the code have rank mn."""
    M = plan.coefficient_matrix()
    rng = np.random.default_rng(0)
    masks = {}
    for n_dead in dead_counts:
        for _ in range(200):
            surv = np.ones(plan.num_workers, dtype=bool)
            surv[rng.choice(plan.num_workers, size=n_dead, replace=False)] = False
            if np.linalg.matrix_rank(M * surv[:, None]) >= plan.m * plan.n:
                masks[n_dead] = surv
                break
    return masks


def _part_coded(smi, seconds: dict) -> None:
    """``run_group_jobs`` over nccl, one rank a card (module docstring)."""
    from chip_smoke import BS, E2E_RTOL, GROUP_RTOL, SEED, main_operands
    from repro_torch.coded import CodedMatmulConfig, plan
    from repro_torch.runtime import run_group_jobs
    from repro_torch.sparse import dense_to_block_ell

    dev = torch.device("cuda", 0)
    A_np, B_np, _ = main_operands()
    ell = dense_to_block_ell(A_np, BS)
    cfg = CodedMatmulConfig(scheme="sparse_code", backend="block_sparse", block_size=BS)
    op = plan(cfg, m=CODED_M, n=CODED_N, num_workers=CARDS, seed=SEED).bind(dev)
    masks = _kill_masks(op.base_plan)
    check(sorted(masks) == [1, 2], f"coded: no decodable mask for some dead count: {masks}")

    def named(mask):
        return "all alive" if mask is None else \
            f"worker(s) {np.flatnonzero(~mask).tolist()} dead"

    configs = [(False, None), (False, masks[1]), (False, masks[2]), (True, None),
               (True, masks[1])]
    # the one-process applies and the dense product on card 0, kept on the host
    A, B = torch.from_numpy(A_np).to(dev), torch.from_numpy(B_np).to(dev)
    ref = (A.T @ B).cpu()
    one = {named(mask): (op if mask is None else op.with_survivors(mask))(
        A, B, a_sparse=ell).cpu() for mask in (None, masks[1], masks[2])}
    del A, B
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reports = run_group_jobs(A_np, B_np, op.base_plan, backend="nccl", configs=configs,
                             repeats=CODED_REPEATS, a_sparse=ell, timeout=TIMEOUT_S)
    seconds["coded_launch"] = wall_s = time.perf_counter() - t0
    scale = float(ref.abs().max())
    applies = 1 + CODED_REPEATS  # the warm-up and the timed repeats
    for (sharded, mask), rep in zip(configs, reports, strict=True):
        name = f"{'out_sharded' if sharded else 'replicated'}, {named(mask)}"
        (C,) = rep.blocks
        check(tuple(C.shape) == tuple(ref.shape), f"coded {name}: C {tuple(C.shape)}")
        C = C.cpu()
        check(bool(torch.isfinite(C).all()), f"coded {name}: non-finite C")
        want = one[named(mask)]
        vs_one = float((C - want).abs().max()) / float(want.abs().max())
        vs_dense = float((C - ref).abs().max()) / scale
        check(vs_one <= GROUP_RTOL, f"coded {name}: {vs_one} of max|C| from the one-process "
                                    f"apply > {GROUP_RTOL}")
        check(vs_dense <= E2E_RTOL, f"coded {name}: rel err {vs_dense} > {E2E_RTOL}")
        stats = rep.decode_stats
        for rank in stats["ranks"]:
            got = {k: v for k, v in rank["launches"].items() if v}
            check(got == {"spmm_block_fused_decode": applies},
                  f"coded {name}: rank {rank['rank']} launched {got}, want {applies} "
                  f"fused-decode (one an apply)")
        emit(part="coded", config=name, ranks=stats["group"], backend=stats["backend"],
             collective_path=stats["collective_path"], out_sharded=sharded,
             plan={"scheme": cfg.scheme, "m": CODED_M, "n": CODED_N, "workers": CARDS,
                   "seed": SEED}, operands=list(A_np.shape) + [B_np.shape[1]],
             survivors=None if mask is None else mask.tolist(), repeats=CODED_REPEATS,
             launch_wall_s=wall_s, configs_a_launch=len(configs),
             apply_ms_slowest_rank=rep.total_time * 1e3,
             rel_err_vs_one_process=vs_one, rtol_one_process=GROUP_RTOL,
             rel_err_vs_dense=vs_dense, rtol=E2E_RTOL, nvidia_smi=smi,
             by_rank=[{k: rank[k] for k in ("rank", "kernel_ms", "collective_ms", "apply_ms",
                                            "samples", "launches", "collectives",
                                            "max_memory_allocated", "shard_shape")}
                      for rank in stats["ranks"]])


def _part_lm(group, smi) -> None:
    lm = group(_lm_rank)
    check(lm[0]["loss_rel_err"] <= 1e-5, f"lm: step-0 loss {lm[0]['loss']} vs one process "
                                         f"{lm[0]['one_process_loss']}")
    emit(part="lm", arch=LM_ARCH, mesh=MESH, batch=LM_BATCH, seq=LM_SEQ, steps=LM_STEPS,
         nvidia_smi=smi, loss=lm[0]["loss"], one_process_loss=lm[0]["one_process_loss"],
         loss_rel_err=lm[0]["loss_rel_err"], losses=lm[0]["losses"],
         by_rank=[{k: r[k] for k in ("step_s", "tokens_per_s", "max_memory_allocated",
                                     "first_value_and_grad_s")} for r in lm])


def _part_restart() -> None:
    with tempfile.TemporaryDirectory(prefix="mesh_restart_") as tmp:
        rc1, out1, s1 = _cli(tmp, "--nproc", "4", "--simulate-failure", str(RESTART_FAIL))
        check(rc1 == 17 and "[train] mesh {'data': 2, 'model': 2}" in out1,
              f"restart: the failing run exited {rc1}: {out1[-3000:]}")
        rc2, out2, s2 = _cli(tmp, "--nproc", "2", "--elastic", "--model-parallel", "2")
        check(rc2 == 0 and "[train] mesh {'data': 1, 'model': 2}" in out2
              and "resumed from step 5" in out2, f"restart: resume exited {rc2}: {out2[-3000:]}")
    with tempfile.TemporaryDirectory(prefix="mesh_one_") as tmp:
        rc3, out3, s3 = _cli(tmp, "--ckpt-every", "0")
    got, want = {**_cli_losses(out1), **_cli_losses(out2)}, _cli_losses(out3)
    check(rc3 == 0 and sorted(got) == sorted(want) == [0, 10, 11]
          and all(abs(got[s] - want[s]) <= RESTART_ATOL for s in got),
          f"restart: losses {got} vs one process {want}")
    emit(part="restart", args=RESTART_CLI, fail_at=RESTART_FAIL, losses=got,
         one_process_losses=want, atol=RESTART_ATOL, seconds=[s1, s2, s3])


def _part_families(group, smi) -> None:
    fam = group(_families_rank, timeout=FAM_TIMEOUT_S)
    for name, row in fam[0].items():
        tr = row["train"]
        check(tr["loss_rel_err"] <= FAM_LOSS_RTOL and tr["grad_rel_err"] <= FAM_GRAD_RTOL,
              f"families {name} train: {tr}")
        if "decode" in row:
            dec = row["decode"]
            check(dec["tokens_equal"] and dec["logit_err"] <= FAM_LOGIT_RTOL,
                  f"families {name} decode: {dec}")
    for name in fam[0]:
        by_rank = []
        for r in fam:
            row = r[name]
            tr, dec = row["train"], row.get("decode", {})
            by_rank.append({"step_s": tr.get("step_s", [tr.get("fwd_bwd_s")])[0],
                            "prefill_ms": dec.get("prefill_ms"),
                            "decode_ms_per_token": dec.get("decode_ms_per_token"),
                            "max_memory_allocated": max(
                                (x for x in (tr.get("max_memory_allocated"),
                                             dec.get("max_memory_allocated"),
                                             row.get("max_memory_allocated")) if x is not None),
                                default=None)})
        row0 = fam[0][name]
        emit(part="families", model=name, mesh=MESH, train_batch=[FAM_BATCH, FAM_SEQ],
             decode_sizes=[DEC_BATCH, DEC_PROMPT, DEC_NEW], nvidia_smi=smi,
             loss_rtol=FAM_LOSS_RTOL, grad_rtol=FAM_GRAD_RTOL, logit_rtol=FAM_LOGIT_RTOL,
             train={k: v for k, v in row0["train"].items() if k != "grad_rel_errs"},
             decode=row0.get("decode"), by_rank=by_rank)


def _part_dryrun(group, smi, seconds: dict) -> None:
    """The fake mesh's dry runs, each a host process of its own, beside
    the cards' run of the same cells."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, "-c", _FAKE_CELL, name], cwd=ROOT,
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for name in DRY_CELLS}
    try:
        real = group(_dry_rank)
        fake = {}
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=TIMEOUT_S)
            check(proc.returncode == 0, f"dryrun {name}: the fake mesh's run failed: "
                                        f"{err[-3000:]}")
            fake[name] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds["dryrun_fake_and_cards"] = time.perf_counter() - t0
    for name, rec in fake.items():
        ma = rec["memory_analysis"]
        tol = DRY_ARG_RTOL * ma["argument_bytes"] + DRY_ARG_SLACK
        for rank, r in enumerate(real):
            check(abs(r[name]["card_argument_bytes"] - ma["argument_bytes"]) <= tol,
                  f"dryrun {name} rank {rank}: arguments {r[name]['card_argument_bytes']} "
                  f"bytes on the card, the dry run says {ma['argument_bytes']} (+- {tol})")
        check(rec["collectives"] == real[0][name]["collectives"],
              f"dryrun {name}: fake mesh {rec['collectives']} vs rank 0 on the cards "
              f"{real[0][name]['collectives']}")
        lo, hi = DRY_PEAK_BAND
        for rank, r in enumerate(real):
            ratio = r[name]["card_peak_bytes"] / ma["peak_bytes_est"]
            check(lo <= ratio <= hi, f"dryrun {name} rank {rank}: the card's peak "
                                     f"{r[name]['card_peak_bytes']} is {ratio} of the "
                                     f"estimate {ma['peak_bytes_est']}, not in {DRY_PEAK_BAND}")
        emit(part="dryrun", cell=name, arch=DRY_CELLS[name][0], shape=DRY_CELLS[name][1],
             mesh=MESH, nvidia_smi=smi, collectives=rec["collectives"],
             collectives_equal=True, meta_s=rec["meta_s"],
             argument_bytes=ma["argument_bytes"], argument_tol=tol,
             peak_bytes_est=ma["peak_bytes_est"], temp_bytes=ma["temp_bytes"],
             peak_band=DRY_PEAK_BAND,
             flops_per_device=rec["cost_analysis"]["flops_per_device"],
             by_rank=[{"card_argument_bytes": r[name]["card_argument_bytes"],
                       "card_peak_bytes": r[name]["card_peak_bytes"],
                       "card_peak_over_est": r[name]["card_peak_bytes"] / ma["peak_bytes_est"],
                       "gc_freed_bytes": r[name]["gc_freed_bytes"],
                       "step_s": r[name]["step_s"]} for r in real])


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"chip_mesh: needs {CARDS} CUDA cards, found {n}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.runtime.procpool import stop_fork_server
    from repro_torch.runtime.workergroup import spawn_group

    parts = sys.argv[1:] or list(PARTS)
    unknown = set(parts) - set(PARTS)
    if unknown:
        print(f"chip_mesh: unknown parts {sorted(unknown)}; parts {PARTS}", file=sys.stderr)
        return 2
    smi = _smi()
    for line in smi:
        print(line, flush=True)
    seconds = {}

    def group(fn, mesh=MESH, timeout=TIMEOUT_S):
        t0 = time.perf_counter()
        out = spawn_group(fn, CARDS, backend="nccl", timeout=timeout, mesh=mesh)
        seconds[fn.__name__] = time.perf_counter() - t0
        return out

    def part_bandwidth():
        bw = group(_bandwidth_rank)
        emit(part="bandwidth", cards=CARDS, backend="nccl", repeats=BW_REPEATS, nvidia_smi=smi,
             rank0=bw[0], slowest_rank_s={k: max(r[k]["median_s"] for r in bw) for k in bw[0]})

    def part_moe():
        moe = group(_moe_rank)
        for form, row in moe[0].items():
            check(row["loss_rel_err"] <= row["rtol"] and row["grad_rel_err"] <= row["grad_rtol"],
                  f"moe {form}: {row}")
        emit(part="moe", arch=MOE_ARCH, layers=MOE_LAYERS, batch=MOE_BATCH, seq=MOE_SEQ,
             pad_batch=MOE_PAD_BATCH, mesh=MESH, nvidia_smi=smi, forms=moe[0],
             fwd_bwd_ms_by_rank={
                 form: [r[form]["fwd_bwd_ms"] for r in moe] for form in moe[0]})

    run = {"bandwidth": part_bandwidth, "coded": lambda: _part_coded(smi, seconds),
           "lm": lambda: _part_lm(group, smi),
           "restart": _part_restart, "moe": part_moe,
           "families": lambda: _part_families(group, smi),
           "dryrun": lambda: _part_dryrun(group, smi, seconds)}
    failed = {}
    for part in PARTS:  # a failed part fails the script, after the others have run
        if part in parts:
            try:
                run[part]()
            except (SystemExit, Exception) as e:  # noqa: BLE001 -- reported, and fails below
                failed[part] = f"{type(e).__name__}: {e}"
                print(e, file=sys.stderr, flush=True)
    stop_fork_server()
    emit(part="seconds", **seconds)
    if failed:
        print(f"chip_mesh: FAILED parts {sorted(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
