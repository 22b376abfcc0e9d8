"""The analysis CLI: ``python -m repro_torch.analysis [--strict] [--json PATH] [--only L] [--device D]``.

Runs the port's two analysis layers (schemes -> contracts, cheapest
first), aggregates their findings into one ``Report``, prints
human-readable ``file:line`` findings, and exits nonzero on violations:

* exit 1 -- error findings (or, under ``--strict``, any warning);
* exit 2 -- a requested layer checked zero units (a vacuous pass is a fail).

The contracts layer captures every registered scheme's coded matmul
through the real ``CodedOp`` path on ``--device``: the CUDA card by
default (raising where there is none), or ``cpu``, where the kernels'
plain versions run -- in this process, and one worker a process in the
ranks of a gloo worker group on the same device, whose programs it counts
too.  The schemes layer is host only.  ``--json`` adds the kernels' launch
counts of the run, the ranks' included (``launches``), to the report.
"""

from __future__ import annotations

import argparse
import json
import sys

LAYERS = ("schemes", "contracts")


def _json(report, rank_launches: dict) -> str:
    from repro_torch.analysis.contracts import launch_counts

    launches = {k: v + rank_launches.get(k, 0) for k, v in launch_counts().items()}
    return json.dumps({**report.as_dict(), "launches": launches},
                      indent=2, sort_keys=True)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant checks: code schemes, the staged coded "
                    "matmul's structural contracts")
    parser.add_argument("--strict", action="store_true",
                        help="treat warnings as failures (the CI gate)")
    parser.add_argument("--json", metavar="PATH", default=None,
                        help="also write the full report as JSON ('-' for "
                             "stdout)")
    parser.add_argument("--only", action="append", choices=LAYERS,
                        default=None, metavar="LAYER",
                        help="run only this layer (repeatable; default all)")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    layers = tuple(args.only) if args.only else LAYERS

    from repro_torch.analysis.findings import Report
    from repro_torch.core.blocks import resolve_device

    device = resolve_device(args.device)
    report = Report()
    rank_launches: dict = {}
    if "schemes" in layers:
        from repro_torch.analysis.schemes import run_scheme_checks

        findings, schemes = run_scheme_checks()
        report.extend(findings)
        report.checked["schemes"] = schemes
    if "contracts" in layers:
        from repro_torch.analysis.contracts import run_contract_checks

        findings, programs = run_contract_checks(device, rank_launches)
        report.extend(findings)
        report.checked["contracts"] = programs

    if args.json == "-":
        print(_json(report, rank_launches))
    else:
        print(report.render())
        if args.json:
            with open(args.json, "w") as fh:
                fh.write(_json(report, rank_launches) + "\n")
    return report.exit_code(strict=args.strict)


if __name__ == "__main__":
    sys.exit(main())
