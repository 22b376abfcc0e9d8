"""Device time of the fused-decode SpMM launches over the window, per apply
(the profiler's kernels named ``spmm_block_fused``)."""

UNIT = "ms"
KERNEL = "spmm_block_fused"


def read(readings):
    tr = readings.trace
    if tr is None:
        return None
    us = [d for name, cat, _, d in tr.device_ops if cat == "kernel" and KERNEL in name]
    return sum(us) / 1e3 / readings.applies if us else None
