"""Training driver: config-driven, checkpointed, restartable.

* the train step of ``repro_torch.training`` on one device: the CUDA card
  unless ``--device cpu`` is given (without a card the driver raises);
* periodic async checkpoints, and resume from the latest on restart;
* ``--coded-ckpt``: also erasure-code the parameters across 24 targets,
  restorable from any full-rank subset;
* ``--simulate-failure N``: exit 17 after step N (the restart test);
* ``--layers N`` (not in the JAX driver): the config at its width, N
  layers deep, to keep a full-width run's checkpoints small.

``--elastic`` (rebuild the mesh from the devices left) needs the port's
device mesh and raises ``NotImplementedError`` until it is ported.  On one
device the JAX driver builds no mesh, so ``--model-parallel`` without
``--elastic`` changes nothing there, nor here.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --reduced --steps 50 --batch 8 --seq 128
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
from repro_torch.models import build
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.data import SyntheticCorpus
from repro_torch.training.optimizer import AdamW, cosine_warmup_schedule
from repro_torch.training.train_step import make_train_step
from repro_torch.training.tree import tree_leaves


def main(argv=None):
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
                    help="build the mesh from the available devices")
    ap.add_argument("--model-parallel", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.elastic:
        raise NotImplementedError("--elastic needs the device mesh, which is not ported "
                                  "to repro_torch yet (ROADMAP queue 1, item 8)")
    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = build(cfg, device)

    opt = AdamW(lr=cosine_warmup_schedule(args.lr, args.warmup, args.steps),
                state_dtype=getattr(torch, args.opt_dtype))
    step_fn = make_train_step(model, opt)

    ckpt_dir = pathlib.Path(args.ckpt_dir) / cfg.name
    start = ckpt_lib.latest_step(ckpt_dir)
    params = model.init(0, torch.float32)
    opt_state = opt.init(params)
    if start is not None:
        params, opt_state, start = ckpt_lib.restore_checkpoint(ckpt_dir, params, opt_state)
        print(f"[train] resumed from step {start}")
    else:
        start = 0
        print(f"[train] fresh start; params="
              f"{sum(p.numel() for p in tree_leaves(params)):,}")

    corpus = SyntheticCorpus(cfg, args.batch, args.seq, seed=0)
    saver = ckpt_lib.AsyncCheckpointer(ckpt_dir)
    t0 = time.time()
    for step in range(start, args.steps):
        params, opt_state, metrics = step_fn(params, opt_state, corpus.make_batch(step))
        if step % 10 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            dt = time.time() - t0
            print(f"[train] step {step:5d} loss {loss:8.4f} gnorm {gn:8.3f} "
                  f"({dt:6.1f}s)", flush=True)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            saver.save(step + 1, params, opt_state)
            if args.coded_ckpt:
                ckpt_lib.save_coded_checkpoint(ckpt_dir, step + 1, params, device=device)
        if args.simulate_failure and step + 1 == args.simulate_failure:
            saver.wait()
            print(f"[train] SIMULATED FAILURE at step {step + 1}", flush=True)
            sys.exit(17)
    saver.wait()
    print(f"[train] done: {args.steps} steps in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
