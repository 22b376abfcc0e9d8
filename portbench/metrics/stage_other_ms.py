"""Device time of every device operation of the window but the SpMM
launches (the staging's stack and sum, the slot order's sort, the index
check's reductions, copies, sets), per apply."""

UNIT = "ms"
KERNEL = "spmm_block_fused"


def read(readings):
    tr = readings.trace
    if tr is None or not any(KERNEL in name for name, *_ in tr.device_ops):
        return None
    us = sum(d for name, _, _, d in tr.device_ops if KERNEL not in name)
    return us / 1e3 / readings.applies
