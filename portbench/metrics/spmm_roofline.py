"""The fused-decode SpMM launches' share of their roofline: 100 x the
least time the yardstick counts for them (``yardstick.apply_bound_s``,
from the inputs' own work) over the device time they took."""

UNIT = "%"
KERNEL = "spmm_block_fused"


def read(readings):
    tr = readings.trace
    if tr is None or readings.spmm_bound_s is None:
        return None
    us = sum(d for name, cat, _, d in tr.device_ops if cat == "kernel" and KERNEL in name)
    return 100.0 * readings.spmm_bound_s / (us / 1e6) if us else None
