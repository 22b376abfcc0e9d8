"""The analysis CLI: ``python -m repro_torch.analysis [--strict] [--json PATH] [--only L] [--device D]``.

Runs the port's two analysis layers (schemes -> contracts, cheapest
first), aggregates their findings into one ``Report``, prints
human-readable ``file:line`` findings, and exits nonzero on violations:

* exit 1 -- error findings (or, under ``--strict``, any warning);
* exit 2 -- a requested layer checked zero units (a vacuous pass is a fail).

The contracts layer captures every registered scheme's coded matmul
through the real ``CodedOp`` path on ``--device``: the CUDA card by
default (raising where there is none), or ``cpu``, where the kernels'
plain versions run.  The schemes layer is host only.  ``--json`` adds the
kernels' launch counts of the run (``launches``) to the report.
"""

from __future__ import annotations

import argparse
import json
import sys

LAYERS = ("schemes", "contracts")


def _json(report) -> str:
    from repro_torch.analysis.contracts import launch_counts

    return json.dumps({**report.as_dict(), "launches": launch_counts()},
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
    if "schemes" in layers:
        from repro_torch.analysis.schemes import run_scheme_checks

        findings, schemes = run_scheme_checks()
        report.extend(findings)
        report.checked["schemes"] = schemes
    if "contracts" in layers:
        from repro_torch.analysis.contracts import run_contract_checks

        findings, programs = run_contract_checks(device)
        report.extend(findings)
        report.checked["contracts"] = programs

    if args.json == "-":
        print(_json(report))
    else:
        print(report.render())
        if args.json:
            with open(args.json, "w") as fh:
                fh.write(_json(report) + "\n")
    return report.exit_code(strict=args.strict)


if __name__ == "__main__":
    sys.exit(main())
