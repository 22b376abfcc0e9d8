"""The share of the traced window in which no device operation ran on the
card: 100 x (1 - the union of the profiler's device intervals over the
window)."""

UNIT = "%"


def read(readings):
    tr = readings.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
