"""Training driver: config-driven, checkpointed, restartable, elastic.

* the train step of ``repro_torch.training``, on the CUDA card unless
  ``--device cpu`` is given (without a card the driver raises);
* ``--nproc N`` ranks (default 1), launched through
  ``runtime.workergroup.spawn_group`` (one rank: this process, in a group
  of its own), over nccl on the card (one card a rank, refused with fewer
  cards than ranks) and over gloo with ``--device cpu``.  A JAX process sees every local device; a torch process drives
  one, so the world is named here;
* with N > 1 or ``--elastic`` the step runs sharded on the mesh
  ``make_mesh_for_devices(N, --model-parallel or min(2, N))``: FSDP over
  "data" and tensor parallel over "model", the parameters and the
  optimizer's m and v placed by ``Model.specs()`` (DTensors), ``count``
  replicated; rank 0 prints the reference's ``[train]`` lines;
* periodic async checkpoints, and resume from the latest on restart (a
  checkpoint holds full values, so ``--elastic`` resumes on another mesh);
* ``--coded-ckpt``: also erasure-code the parameters across 24 targets,
  restorable from any full-rank subset;
* ``--simulate-failure N``: every rank ends after step N, once the
  checkpoint is written, and the driver exits 17 (the restart test);
* ``--layers N`` (not in the JAX driver): the config at its width, N
  layers deep, to keep a full-width run's checkpoints small.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --reduced --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --reduced --nproc 4 --device cpu --elastic
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import tempfile
import time

import torch

import repro_torch.configs as configs
from repro_torch.core.blocks import resolve_device
from repro_torch.launch import meshctx
from repro_torch.launch.mesh import make_mesh_for_devices
from repro_torch.models import build
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.data import SyntheticCorpus, distribute_batch
from repro_torch.training.optimizer import AdamW, cosine_warmup_schedule
from repro_torch.training.train_step import make_train_step
from repro_torch.training.tree import tree_leaves

#: the exit code of a simulated failure
FAILURE_EXIT = 17
#: seconds a sharded run's ranks may take, start-up included
#: (``spawn_group``'s wall limit)
WALL_LIMIT_S = 3600.0


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced config (CPU-feasible)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers, at full width "
                         "(0: the config's depth)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=str(pathlib.Path(tempfile.gettempdir())
                                              / "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--coded-ckpt", action="store_true",
                    help="also write sparse-code erasure shards")
    ap.add_argument("--opt-dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--simulate-failure", type=int, default=0,
                    help="exit(17) at this step (restart test)")
    ap.add_argument("--elastic", action="store_true",
                    help="build the mesh from the available devices (TP capped)")
    ap.add_argument("--model-parallel", type=int, default=0)
    ap.add_argument("--nproc", type=int, default=1,
                    help="ranks (devices) to train on")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def train(args, device: torch.device, dmesh=None) -> int:
    """The training loop on ``device``; on the ``DeviceMesh`` ``dmesh``
    where given (every rank runs it, rank 0 prints).  Returns the exit
    code."""
    say = print if dmesh is None or dmesh.get_rank() == 0 else (lambda *a, **k: None)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = build(cfg, device)
    if dmesh is not None:
        meshctx.set_mesh(dmesh)
        say(f"[train] mesh {meshctx.mesh_shape(dmesh)}", flush=True)

    opt = AdamW(lr=cosine_warmup_schedule(args.lr, args.warmup, args.steps),
                state_dtype=getattr(torch, args.opt_dtype))
    step_fn = make_train_step(model, opt)

    ckpt_dir = pathlib.Path(args.ckpt_dir) / cfg.name
    start = ckpt_lib.latest_step(ckpt_dir)
    params = model.init(0, torch.float32)
    n_params = sum(p.numel() for p in tree_leaves(params))
    if dmesh is not None:  # each rank keeps its shards; the full init goes
        params = meshctx.distribute(params, model.specs(), dmesh)
    opt_state = opt.init(params)
    if start is not None:
        params, opt_state, start = ckpt_lib.restore_checkpoint(ckpt_dir, params, opt_state)
        say(f"[train] resumed from step {start}")
    else:
        start = 0
        say(f"[train] fresh start; params={n_params:,}")

    corpus = SyntheticCorpus(cfg, args.batch, args.seq, seed=0)
    saver = ckpt_lib.AsyncCheckpointer(ckpt_dir)
    t0 = time.time()
    for step in range(start, args.steps):
        batch = distribute_batch(corpus.make_batch(step), dmesh, device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % 10 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            dt = time.time() - t0
            say(f"[train] step {step:5d} loss {loss:8.4f} gnorm {gn:8.3f} "
                f"({dt:6.1f}s)", flush=True)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            saver.save(step + 1, params, opt_state)
            if args.coded_ckpt:
                ckpt_lib.save_coded_checkpoint(ckpt_dir, step + 1, params, device=device)
        if args.simulate_failure and step + 1 == args.simulate_failure:
            saver.wait()
            say(f"[train] SIMULATED FAILURE at step {step + 1}", flush=True)
            return FAILURE_EXIT
    saver.wait()
    say(f"[train] done: {args.steps} steps in {time.time() - t0:.1f}s")
    return 0


def _rank_train(device, dmesh, argv) -> int:
    """One rank of a sharded run (``spawn_group``'s rank function)."""
    return train(parse(argv), device, dmesh)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    if args.nproc < 1:
        raise ValueError(f"--nproc must be >= 1, got {args.nproc}")
    if args.nproc == 1 and not args.elastic:
        return train(args, resolve_device(args.device))
    from repro_torch.launch import train as this  # pickled by its module's name
    from repro_torch.runtime.workergroup import group_of_one, spawn_group

    mesh = make_mesh_for_devices(args.nproc, args.model_parallel or min(2, args.nproc))
    # the device fixes the backend: nccl cannot run on the CPU, and gloo
    # crashes in the collectives DTensor runs on CUDA tensors (PERF.md §7)
    cpu = torch.device(args.device or "cuda").type == "cpu"
    if not cpu:
        resolve_device(args.device)  # no card: raises, as with one rank
    backend = "gloo" if cpu else "nccl"
    if args.nproc == 1:  # --elastic on one device: this process is the world
        with group_of_one(backend=backend, device=args.device, mesh=mesh) as (dev, dmesh):
            return train(args, dev, dmesh)
    codes = spawn_group(this._rank_train, args.nproc, backend=backend, device=args.device,
                        timeout=WALL_LIMIT_S, args=(argv,), mesh=mesh)
    return max(codes)


if __name__ == "__main__":
    raise SystemExit(main())
