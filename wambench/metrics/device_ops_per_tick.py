"""Device operations (kernels, copies, fills) a simulated tick, in the
traced window: what the sender's tick loop launches."""

UNIT = "ops/tick"
MOVES = "flow_ticks_per_s"


def read(trace, shape):
    if not trace.ops or trace.ticks <= 0:
        return None
    return len(trace.ops) / trace.ticks
