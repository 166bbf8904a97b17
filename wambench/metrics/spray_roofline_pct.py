"""Share of the Whack-a-Mole spray's least time in the device time of the
operations that do it: F x lanes decisions a tick, each flow reading its
counter, seeds and cumulative profile and writing one path a decision, at
the memory rate (`wambench.roofline.spray_bytes`)."""

from wambench import roofline

UNIT = "%"
MOVES = "flow_ticks_per_s"
OPS = ("spray_select",)


def read(trace, shape):
    seconds = trace.op_seconds(OPS)
    if seconds <= 0:
        return None
    least = trace.ticks * roofline.spray_least_s(shape.flows, shape.paths, shape.lanes)
    return 100.0 * least / seconds
