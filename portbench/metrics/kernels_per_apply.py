"""Kernels the profiler saw the device run in the window, per apply
(copies and sets are not kernels and are not counted)."""

UNIT = "count"


def read(readings):
    tr = readings.trace
    if tr is None:
        return None
    n = sum(1 for _, cat, _, _ in tr.device_ops if cat == "kernel")
    return n / readings.applies if n else None
