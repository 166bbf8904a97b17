"""Share of the traced window in which no operation ran on the device:
one less the union of the device's busy intervals over the window."""

UNIT = "%"
MOVES = "flow_ticks_per_s"


def read(trace, shape):
    if not trace.ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
