"""Format the dry run's and the roofline's JSON records as markdown tables.

    python -m repro_torch.launch.report [--dryrun|--roofline|--perf]

A record shaped as the JAX package writes it renders as that package
renders it: the dry run's collective bytes a device and the roofline's
collective term included.  A field that is ``None`` in the port's records
(what needs XLA: HLO bytes) renders as ``—``, and a dry-run row gives its
sharded meta run's seconds where the JAX package gives its compile's.
"""

from __future__ import annotations

import argparse
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "torch"

NONE = "—"


def _load(d: pathlib.Path):
    recs = []
    if not d.is_dir():
        return recs
    for p in sorted(d.glob("*.json")):
        recs.append(json.loads(p.read_text()))
    return recs


def _gb(x: float) -> str:
    return f"{x/2**30:.2f}"


def _f(x, spec: str) -> str:
    return NONE if x is None else format(x, spec)


def dryrun_table(root: pathlib.Path | str | None = None) -> str:
    """Markdown table of dry-run records under ``root`` (default: the
    port's experiments dir).  Families that errored render as rows
    carrying their error string; an empty or missing record dir renders
    an explicit placeholder row."""
    recs = _load(pathlib.Path(root) if root is not None else ROOT / "dryrun")
    lines = [
        "| arch | shape | mesh | status | compile_s | flops/dev | HLO bytes/dev | coll bytes/dev | arg GiB/dev | temp GiB/dev |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    if not recs:
        lines.append("| (no dryrun records -- run "
                     "`PYTHONPATH=src python -m repro_torch.launch.dryrun`) "
                     "| | | | | | | | | |")
    for r in recs:
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"{r['status']}: {r.get('reason', r.get('error', ''))[:60]} "
                         "| | | | | | |")
            continue
        ca = r["cost_analysis"]
        ma = r.get("memory_analysis", {})
        seconds = r["compile_s"] if "compile_s" in r else f"{r['meta_s']} (meta)"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | {seconds} "
            f"| {ca['flops_per_device']:.3g} | {_f(ca['bytes_per_device'], '.3g')} "
            f"| {r['collectives']['total_bytes']:.3g} "
            f"| {_gb(ma.get('argument_bytes', 0))} | {_gb(ma.get('temp_bytes', 0))} |")
    return "\n".join(lines)


def roofline_table(include_variants: bool = False,
                   root: pathlib.Path | str | None = None) -> str:
    recs = _load(pathlib.Path(root) if root is not None else ROOT / "roofline")
    lines = [
        "| arch | shape | opts | compute_s | memory_s | collective_s | dominant "
        "| MODEL_FLOPS | HLO_FLOPS | useful | roofline<= |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        opts = "+".join(r.get("opts", [])) or "baseline"
        if not include_variants and opts != "baseline":
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {opts} | "
                         f"{r['status']}: {r.get('reason', r.get('error',''))[:50]} "
                         "| | | | | | |")
            continue
        t = r["terms"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {opts} "
            f"| {t['compute_s']:.4g} | {t['memory_s']:.4g} | {t['collective_s']:.4g} "
            f"| {r['dominant'].replace('_s','')} "
            f"| {r['model_flops']:.3g} | {r['hlo_flops_total']:.3g} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction_bound']:.2%} |")
    return "\n".join(lines)


def perf_table(root: pathlib.Path | str | None = None) -> str:
    """Baseline vs optimized, per cell that has variants."""
    recs = _load(pathlib.Path(root) if root is not None else ROOT / "roofline")
    by_cell: dict = {}
    for r in recs:
        if r["status"] != "ok":
            continue
        key = (r["arch"], r["shape"])
        by_cell.setdefault(key, {})["+".join(r.get("opts", [])) or "baseline"] = r
    lines = [
        "| cell | variant | compute_s | memory_s | collective_s | dominant | step bound | vs baseline |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), variants in sorted(by_cell.items()):
        if len(variants) < 2:
            continue
        base = variants.get("baseline")
        base_bound = max(base["terms"].values()) if base else None
        for name, r in sorted(variants.items(), key=lambda kv: kv[0] != "baseline"):
            t = r["terms"]
            bound = max(t.values())
            rel = f"{base_bound / bound:.2f}x" if base_bound and name != "baseline" else "--"
            lines.append(
                f"| {arch}/{shape} | {name} | {t['compute_s']:.4g} | {t['memory_s']:.4g} "
                f"| {t['collective_s']:.4g} | {r['dominant'].replace('_s','')} "
                f"| {bound:.4g} | {rel} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--roofline", action="store_true")
    ap.add_argument("--perf", action="store_true")
    ap.add_argument("--root", default=str(ROOT),
                    help="directory holding dryrun/ and roofline/")
    args = ap.parse_args(argv)
    root = pathlib.Path(args.root)
    if args.dryrun or not (args.roofline or args.perf):
        print("## Dry-run\n")
        print(dryrun_table(root / "dryrun"))
    if args.roofline:
        print("## Roofline (single-pod baselines)\n")
        print(roofline_table(root=root / "roofline"))
    if args.perf:
        print("## Perf (baseline vs optimized)\n")
        print(perf_table(root / "roofline"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
