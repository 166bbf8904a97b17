"""The comparison that decides ``correct``: the program's answers against
the plain reference's, field by field, bit for bit.

Each layer the cell runs gives one number, the count of elements of its
fields whose bits differ between the two over the checked runs, and each
number's limit is 0: the system promises the reference's exact result,
and every field is an exact function of the inputs.
"""
from __future__ import annotations

import numpy as np

from wambench.reference import policies

LAYERS = {
    "spray": ("sent_total",),                   # the spray decisions, per flow and path
    "controller": ("final_b",),                 # the profile controller's last profile
    "fabric": ("link_served", "link_busy", "dropped_total", "received"),
    "sender": ("cct", "finished", "ticks_run"),
}
LIMIT = 0


def layers_for(policy: str) -> tuple:
    """The layers a run under ``policy`` exercises."""
    adaptive = policies.find(policy).CONTROLLER
    return tuple(k for k in LAYERS if k != "controller" or adaptive)


def differing(a, b) -> int:
    """Elements of ``a`` and ``b`` whose bits differ (all of them where the
    shapes do)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return int(max(a.size, b.size, 1))
    if a.dtype.kind == "f":
        a, b = a.view(f"i{a.itemsize}"), b.view(f"i{b.itemsize}")
    return int(np.count_nonzero(a != b))


def compare(got: dict, want: dict, layers) -> dict:
    """``{layer: differing elements}`` of one run."""
    return {k: sum(differing(got[f], want[f]) for f in LAYERS[k]) for k in layers}
