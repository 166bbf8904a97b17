"""Reading a `torch.profiler` window: the device's operations, its busy
time, and what the host was doing while the device sat idle.

The harness wraps the traced runs in one span named `WINDOW`; every
number here is taken inside it.  Device operations are the kernels,
copies and fills the profiler records on the card (not the annotations it
mirrors there); busy time is the union of their intervals.  An idle gap
is named after the host operation that launched the device operation
ending it (the outermost ``aten::`` call around its launch), or the
runtime call itself where no such op is found.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

import torch

WINDOW = "wambench.window"


def _annotation(e) -> bool:
    check = getattr(e, "is_user_annotation", None)  # not in every torch version
    return bool(check()) if check is not None else False


@dataclasses.dataclass
class Trace:
    """What the per-layer readers read: the traced window's device
    operations ``(name, start_ns, end_ns)`` in start order, its length,
    the ticks its runs made, and the peak memory the window allocated."""

    ops: list
    window_s: float
    ticks: int
    peak_bytes: int
    gap_labels: list = dataclasses.field(default_factory=list)

    def busy_s(self) -> float:
        busy, end = 0, None
        for _, a, b in self.ops:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy * 1e-9

    def op_seconds(self, names) -> float:
        """Device seconds of the operations whose name holds any of ``names``."""
        return sum(b - a for n, a, b in self.ops if any(k in n for k in names)) * 1e-9

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(int)
        for n, a, b in self.ops:
            by[n] += b - a
        return [[n, ns * 1e-9] for n, ns in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle seconds between device operations, summed by the host
        operation that launched the one after the gap; the ``k`` largest."""
        by = defaultdict(int)
        end = None
        for (_, a, b), label in zip(self.ops, self.gap_labels):
            if end is not None and a > end:
                by[label] += a - end
            end = b if end is None else max(end, b)
        return [[n, ns * 1e-9] for n, ns in sorted(by.items(), key=lambda x: -x[1])[:k]]


def _top_level(cpu: list) -> tuple:
    """The outermost host operations, as sorted (starts, ends, names)."""
    starts, ends, names = [], [], []
    for name, a, b in sorted(cpu, key=lambda e: (e[1], -e[2])):
        if ends and a < ends[-1]:
            continue
        starts.append(a)
        ends.append(b)
        names.append(name)
    return starts, ends, names


def read(prof, ticks: int, peak_bytes: int) -> Trace:
    """The `Trace` of a finished profile whose window span is `WINDOW`."""
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    device, cpu_ops, launches = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == cuda:
            # the card's copy of a host annotation is no device operation
            if name != WINDOW and not _annotation(e):
                device.append((name, a, b, e.correlation_id()))
        elif name == WINDOW:
            window = (a, b)
        elif name.startswith(("cuda", "cu")):
            launches[e.correlation_id()] = (name, a)
        elif name.startswith("aten::"):
            cpu_ops.append((name, a, b))
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW} span")
    lo, hi = window
    device = sorted((d for d in device if lo <= d[1] and d[2] <= hi), key=lambda d: d[1])
    starts, ends, names = _top_level(cpu_ops)
    labels = []
    for _, _, _, corr in device:
        launch = launches.get(corr)
        if launch is None:
            labels.append("unknown")
            continue
        i = bisect.bisect_right(starts, launch[1]) - 1
        labels.append(names[i] if i >= 0 and ends[i] >= launch[1] else launch[0])
    return Trace(ops=[d[:3] for d in device], window_s=(hi - lo) * 1e-9, ticks=ticks,
                 peak_bytes=peak_bytes, gap_labels=labels)
