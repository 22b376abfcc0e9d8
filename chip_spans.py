"""The program's spans in one traced benchmark run: counts and host ms an apply.

    python3 chip_spans.py --workload paper-square-16k.steady --seed 7 --seconds 50

Runs ``portbench/run.py`` with ``--trace 1`` in this process, so its lines
come first as they always do, with every idle gap of the window in the
breakdown (the run itself keeps ten).  Then it reads the profiler's events
of that window once more and prints one line ``SPANS {...}``: the window's
applies and its ms an apply; for each span of the program
(``repro_torch.trace``) and of the harness (``apply``, ``rebind``) its count
and its host ms an apply; and the card's idle ms an apply split by the
innermost program span open on the host at each instant (``idle``:
"outside" where none was), and by that span and the innermost host
operation (``idle_by_op``: ``kernel.check_indices/cudaMemcpyAsync`` is a
copy made there).  Run from a checkout's root; nothing of JAX is imported.
"""

from __future__ import annotations

import json
import sys

from portbench import tracing
from portbench.tracing import DEVICE_CATS, HOST_CATS, WINDOW_SPAN

#: the harness's span of an apply
APPLY_SPAN = "apply"
#: the program's span names start so (``repro_torch.trace``)
PROGRAM = ("coded.", "kernel.")


def summarize(events: list) -> dict | None:
    """Counts and host ms an apply of each ``user_annotation`` span inside
    the window span, and the card's idle ms an apply by span, from a Chrome
    trace's events; None without a window or an apply."""
    win = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("ph") == "X"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    count, host_us = {}, {}
    host, busy = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e or e["name"] == WINDOW_SPAN:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS and b > w0 and a < w1:
            busy.append((max(a, w0), min(b, w1)))
        # the host's nesting is the thread's that ran the window
        if cat not in HOST_CATS or e.get("tid") != win[0].get("tid") or b <= w0 or a >= w1:
            continue
        host.append((a, b, e["name"]))
        if cat == "user_annotation" and w0 <= a and b <= w1:
            count[e["name"]] = count.get(e["name"], 0) + 1
            host_us[e["name"]] = host_us.get(e["name"], 0.0) + float(e["dur"])
    applies = count.get(APPLY_SPAN, 0)
    if not applies:
        return None
    idle, idle_by_op = _idle_by_span(_gaps(w0, w1, busy), _innermost(host))

    def per_apply(by):
        return {n: s * 1e3 / applies for n, s in sorted(by.items(), key=lambda kv: -kv[1])}

    return {"applies": applies, "window_ms_per_apply": (w1 - w0) / 1e3 / applies,
            "spans": {name: {"per_apply": count[name] / applies,
                             "host_ms_per_apply": host_us[name] / 1e3 / applies}
                      for name in sorted(count)},
            "idle": per_apply(idle), "idle_by_op": per_apply(idle_by_op)}


def _gaps(w0: float, w1: float, busy: list) -> list:
    """The stretches of [w0, w1] that no device interval covers."""
    edge, gaps = w0, []
    for a, b in sorted(busy) + [(w1, w1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    return gaps


def _innermost(host: list) -> list:
    """Nested host intervals (a, b, name) cut into disjoint segments (a, b,
    innermost program span or None, innermost interval's name)."""
    segs, stack, t = [], [], None

    def cut(upto):
        if stack and upto > t:
            prog = next((n for _, _, n in reversed(stack) if n.startswith(PROGRAM)), None)
            segs.append((t, upto, prog, stack[-1][2]))

    for a, b, name in sorted(host, key=lambda h: (h[0], -h[1])):
        while stack and stack[-1][1] <= a:
            cut(stack[-1][1])
            t = stack.pop()[1]
        cut(a)
        stack.append((a, b, name))
        t = a
    while stack:
        cut(stack[-1][1])
        t = stack.pop()[1]
    return segs


def _idle_by_span(gaps: list, segs: list) -> tuple[dict, dict]:
    """Seconds of the gaps under each segment's program span, and under its
    span and host operation; "outside" where no program span was open."""
    by, by_op = {}, {}
    j = 0
    for a, b in gaps:
        covered = 0.0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s = min(b, segs[k][1]) - max(a, segs[k][0])
            if s > 0:
                prog = segs[k][2] or "outside"
                op = prog if segs[k][3] == segs[k][2] else f"{prog}/{segs[k][3]}"
                by[prog] = by.get(prog, 0.0) + s / 1e6
                by_op[op] = by_op.get(op, 0.0) + s / 1e6
                covered += s
            k += 1
        if b - a > covered:
            by["outside"] = by.get("outside", 0.0) + (b - a - covered) / 1e6
            by_op["outside/host idle"] = by_op.get("outside/host idle", 0.0) + (
                b - a - covered) / 1e6
    return by, by_op


def main(argv: list[str]) -> int:
    from portbench import run  # puts the checkout's src/ on the path

    kept = {}
    reduce = tracing.reduce

    def keep(events):
        kept["events"] = events
        return reduce(events)

    tracing.reduce = keep
    tracing.TOP = 10**6
    code = run.main([*argv, "--trace", "1"])
    if code == 0:
        print("SPANS " + json.dumps(summarize(kept.get("events", []))), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
