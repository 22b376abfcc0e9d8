"""End-to-end training example on PyTorch.

Default: a ~115M-parameter dense LM (same code path as the 10 assigned
archs) for a few hundred steps -- the "train a ~100M model" run; pass
--tiny for a short demonstration of the identical pipeline (synthetic
corpus -> train step -> async checkpoints -> resume).

  PYTHONPATH=src python examples/train_lm_torch.py --tiny --steps 30 [--device cpu]

The counterpart of ``examples/train_lm.py``, over
``repro_torch.launch.train``; ``--device`` (the CUDA card by default,
raising where there is none, or ``cpu``) is passed on to it, as is any
argument this script does not take (``--ckpt-dir``, ...).

Fault-tolerance demo: run with --simulate-failure N, then re-run the same
command -- training resumes from the last checkpoint.
"""

import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.configs.base import ArchConfig, register  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402

LM_100M = register(ArchConfig(
    name="lm-100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    d_ff=3072,
    vocab_size=32_000,
    source="example script (~115M params)",
))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--simulate-failure", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args, rest = ap.parse_known_args(argv)

    argv = ["--arch", "lm-100m", "--steps", str(args.steps),
            "--batch", "4", "--seq", "256", "--ckpt-every", "20",
            "--coded-ckpt"]
    if args.tiny:
        argv += ["--reduced"]
    if args.simulate_failure:
        argv += ["--simulate-failure", str(args.simulate_failure)]
    if args.device:
        argv += ["--device", args.device]
    rc = train_main(argv + rest)
    if rc == 0:
        print(f"OK: trained lm-100m{' (reduced)' if args.tiny else ''} to step {args.steps}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
