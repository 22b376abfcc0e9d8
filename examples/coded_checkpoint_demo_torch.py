"""Coded checkpointing demo on PyTorch: train, erasure-code the checkpoint
with the (P,S)-sparse code across 14 storage targets, destroy 4 of them,
and restore exactly -- the paper's any-K-of-N decodability as fault
tolerance.

  PYTHONPATH=src python examples/coded_checkpoint_demo_torch.py [--device cpu]

The counterpart of ``examples/coded_checkpoint_demo.py`` (whose text says
12 targets where its code writes 14); the training, the encode and the
decode run on ``--device``, the CUDA card by default (raising where there
is none), or ``cpu``.
"""

import argparse
import pathlib
import shutil
import tempfile

import torch

import repro_torch.configs as configs
from repro_torch.core.blocks import resolve_device
from repro_torch.models import build
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.data import SyntheticCorpus
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_step import make_train_step
from repro_torch.training.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    cfg = configs.get("internlm2-1.8b").reduced()
    model = build(cfg, device)
    params = model.init(0, torch.float32)
    opt = AdamW(lr=1e-3)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)
    corpus = SyntheticCorpus(cfg, 2, 32, seed=0)

    for step in range(5):
        params, opt_state, metrics = step_fn(params, opt_state, corpus.make_batch(step))
    print(f"trained 5 steps, loss={float(metrics['loss']):.4f}")

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="coded_ckpt_"))
    try:
        manifest = ckpt_lib.save_coded_checkpoint(tmp, 5, params, m=3, n=3,
                                                  num_targets=14, device=device)
        print(f"wrote {manifest['num_targets']} coded shards "
              f"(mn={manifest['m']*manifest['n']} data chunks)")

        # destroy 4 of 14 storage targets (10 >= mn = 9 survive)
        for k in (1, 4, 7, 10):
            (tmp / "coded_00000005" / f"target_{k:03d}.npz").unlink()
        survivors = [0, 2, 3, 5, 6, 8, 9, 11, 12, 13]
        print(f"destroyed shards [1, 4, 7, 10]; restoring from {survivors}")

        restored, stats = ckpt_lib.restore_coded_checkpoint(
            tmp, 5, params, available=survivors, device=device)
        print(f"decode: {stats.peels} peels, {stats.roots} roots")
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(tree_leaves(params), tree_leaves(restored)))
        print(f"max restore error: {err:.2e}")
        assert err < 1e-4
        print("OK: checkpoint survived losing 4/14 storage targets")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
