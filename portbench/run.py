"""Run one cell of the benchmark and print its result as the last line.

    python3 portbench/run.py --workload paper-square-16k.steady --seed 7 --seconds 50 --trace 0

``--trace 0`` measures the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics under the profiler.  A line before the last says what
fixed the run's work (the code, its degrees, the live tiles and slots, the
failure patterns) and how the card ran (clocks, power).  Standard error
ends with each compared number beside its limit.  Exits non-zero, with no
result, without the cards the cell asks for, or where this process holds
JAX or the JAX package once the window has closed.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
    sys.path.pop(0)  # this folder's modules are reached as ``portbench.*``
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    start = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s), this machine has {cards}",
              file=sys.stderr)
        return 1
    result, work, checks = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                                       start=start)
    forbidden = harness.forbidden_modules() + work["forbidden_modules"]
    if forbidden:
        print(f"JAX or the JAX package was loaded: {sorted(set(forbidden))}", file=sys.stderr)
        return 3
    print(json.dumps({"work": work}), flush=True)
    for line in checks:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
