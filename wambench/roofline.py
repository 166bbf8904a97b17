"""The card's peaks and the least time of each kernel's work.

Peaks are NVIDIA's published figures for the H100 SXM at its full 700 W
power limit; the card's name, power limit and largest SM clock are read
from ``nvidia-smi`` and reported beside every share.  The work of a kernel
is counted from the cell's shapes, never from what the kernel does: each
input byte it must read once, each output byte it must write once, and
for a chain of dependent adds the chain's length.
"""
from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FADD_CYCLES = 4             # latency of one dependent float32 add, in SM cycles


def card() -> dict:
    """name, power limit (W) and largest SM clock (Hz) from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.splitlines()[0]
    name, watts, mhz = (x.strip() for x in out.split(","))
    return dict(name=name, power_limit_w=float(watts), sm_clock_hz=float(mhz) * 1e6)


def spray_bytes(flows: int, paths: int, lanes: int) -> int:
    """One tick of Whack-a-Mole decisions, ``lanes`` a flow: read each
    flow's counter and two seeds (uint32 held in int64) and its cumulative
    profile (int32 [paths]); write one int32 path a decision."""
    return flows * (3 * 8 + 4 * paths + 4 * lanes)


def spray_least_s(flows: int, paths: int, lanes: int) -> float:
    return spray_bytes(flows, paths, lanes) / HBM_BYTES_PER_S


def link_sum_bytes(entries: int, links: int) -> int:
    """One ordered per-link sum: read every (hop, flow, path) value and its
    index, each link's offset and base; write each link's sum."""
    return 4 * (2 * entries + 3 * links + 1)


def link_sum_least_s(entries: int, links: int, depth: int, sm_clock_hz: float) -> float:
    """The larger of the sum's bytes at the memory rate and its deepest
    link's chain of ``depth`` dependent float adds at the SM clock: the
    order of the adds is fixed, so a link's sum is one serial chain."""
    return max(link_sum_bytes(entries, links) / HBM_BYTES_PER_S,
               depth * FADD_CYCLES / sm_clock_hz)
