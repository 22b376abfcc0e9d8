"""The traced run: the window under ``torch.profiler``, reduced to what the
per-layer metric readers read.

The profiler's Chrome trace (its documented export) is read back once:
device operations (kernels, copies, sets) with their start and length, the
host's operations, and the harness's own spans (``record_function``),
among them ``portbench.window`` around the whole window.  Everything is
clipped to that window.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import os
import tempfile

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}
WINDOW_SPAN = "portbench.window"
TOP = 10
#: a device operation's name is cut to this many characters
NAME_CHARS = 96


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    #: (name, category, start us, duration us) of each device operation
    device_ops: list
    #: seconds in which some device operation ran (union of intervals)
    busy_s: float
    #: the longest idle gaps by what the host was doing, [name, seconds]
    idle_gaps: list

    def top_ops(self) -> list:
        by = {}
        for name, _, _, dur in self.device_ops:
            by[name] = by.get(name, 0.0) + dur / 1e6
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:TOP]


def export(prof) -> list:
    """The profiler's trace events (written to a temporary file, read back,
    removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: list) -> DeviceTrace | None:
    """The device trace of the window, or None without a window span."""
    win = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if b <= w0 or a >= w1:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append((e["name"][:NAME_CHARS], cat, a, b - a))
        elif cat in HOST_CATS and e["name"] != WINDOW_SPAN:
            host.append((a, b, cat, e["name"]))
    busy = _union([(max(a, w0), min(a + d, w1)) for _, _, a, d in ops])
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps = []
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    return DeviceTrace(window_s=(w1 - w0) / 1e6, device_ops=ops, busy_s=busy_s,
                       idle_gaps=_attribute(gaps, host))


def _attribute(gaps: list, host: list) -> list:
    """Each idle gap's length under what the host was doing at its middle:
    the outermost harness span and the innermost host operation there."""
    host.sort()
    by = {}
    active, ends, nxt = {}, [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        # a sweep: host operations that started by mid and end after it
        while nxt < len(host) and host[nxt][0] <= mid:
            active[nxt] = host[nxt]
            heapq.heappush(ends, (host[nxt][1], nxt))
            nxt += 1
        while ends and ends[0][0] <= mid:
            active.pop(heapq.heappop(ends)[1], None)
        around = list(active.values())
        spans = [h for h in around if h[2] == "user_annotation"]
        inner = min(around, key=lambda h: h[1] - h[0], default=None)
        parts = []
        if spans:
            parts.append(max(spans, key=lambda h: h[1] - h[0])[3])
        if inner is not None and (not spans or inner[3] != parts[0]):
            parts.append(inner[3])
        name = "/".join(parts) or "host idle"
        by[name] = by.get(name, 0.0) + (b - a) / 1e6
    return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:TOP]
