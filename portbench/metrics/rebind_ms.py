"""Host time of the window's rebinds (``CodedOp.with_survivors``, the
decode matrix of the apply's survivors), from the harness's span around
the call, per apply."""

UNIT = "ms"


def read(readings):
    if readings.rebind_s is None:
        return None
    return readings.rebind_s * 1e3 / readings.applies
