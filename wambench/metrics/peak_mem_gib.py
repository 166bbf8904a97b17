"""Peak device memory allocated in the traced window
(`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`)."""

UNIT = "GiB"
MOVES = "flow_ticks_per_s"


def read(trace, shape):
    if trace.peak_bytes <= 0:
        return None
    return trace.peak_bytes / 2 ** 30
