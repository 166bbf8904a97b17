"""Share of the shared fabric's two ordered per-link sums' least time in
the device time of the operations that do them: each sum bound by the
larger of its bytes at the memory rate and its deepest link's chain of
dependent adds at the SM clock (`wambench.roofline.link_sum_least_s`)."""

from wambench import roofline

UNIT = "%"
MOVES = "flow_ticks_per_s"
OPS = ("link_fold",)
SUMS_A_TICK = 2  # the backlog and the incoming traffic of every link


def read(trace, shape):
    seconds = trace.op_seconds(OPS)
    if seconds <= 0:
        return None
    least = roofline.link_sum_least_s(shape.entries, shape.links, shape.depth,
                                      shape.sm_clock_hz)
    return 100.0 * trace.ticks * SUMS_A_TICK * least / seconds
