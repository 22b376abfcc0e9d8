"""The readings a cell's limits are set from, over many seeds in one process.

    python3 portbench/control.py --workload paper-square-16k.stragglers --seeds 1 2 3 --seconds 3

For each seed, one JSON line: the control's reading (``reference.
control_product`` in the program's place: the widest gap from the
reference at TF32 precision, on card 0, at the cell's own size), and the
program's own readings from a short run of the cell (``harness.run``).
The benchmark's runs never run this.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
    sys.path.pop(0)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness, operands, reference  # noqa: E402


def control_reading(config: dict, seed: int, device) -> float:
    """The control's widest gap from the reference on the seed's operands."""
    ops = operands.draw(config, seed, device)
    ref = reference.product(ops.A, ops.B)
    ctl = reference.control_product(ops.A, ops.B)
    return reference.rel_err(ctl, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    for seed in args.seeds:
        line = {"workload": cell.name, "seed": seed,
                "control_rel_err": control_reading(cell.config, seed, "cuda:0")}
        torch.cuda.empty_cache()
        result, work, _ = harness.run(cell, seed, args.seconds, False)
        line["program"] = {k: c["value"] for k, c in result["checks"].items()}
        line["patterns_checked"] = work["patterns_checked"]
        line["applies"] = work["applies"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
