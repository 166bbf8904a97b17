"""Time-varying path profiles (paper §8).

When paths have heterogeneous latencies, a profile that is optimal for
steady-state throughput is not optimal for message completion: the last bytes
should avoid high-latency paths.  §8's worked example (10 Mbit over
P1 = 100 ms / 100 Mbps, P2 = 10 ms / 50 Mbps) shows a two-phase schedule
(both paths full rate, then P2 only) completing in ~137 ms versus 167/200/210
ms for the best static profiles.

This module provides an exact fluid model for piecewise-constant profile
schedules, the closed-form optimal switch for the two-path case, and a
general latency-aware schedule builder (reverse water-filling: every path's
send window is chosen so its last byte arrives by the common deadline).

Units: bits, milliseconds, Mbps (1 Mbit = 1000 bits * 1000; rate Mbps =
bits/us = 1000 bits/ms).

Pure numpy, the same code as `repro.core.timevarying` (the port imports
nothing of the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "PathSpec",
    "Phase",
    "completion_time",
    "static_profile_completion",
    "optimal_two_path_schedule",
    "reverse_waterfill_schedule",
    "max_rate_for_profile",
]

_BITS_PER_MBIT = 1_000_000.0


@dataclasses.dataclass(frozen=True)
class PathSpec:
    latency_ms: float
    bandwidth_mbps: float

    @property
    def rate_bits_per_ms(self) -> float:
        return self.bandwidth_mbps * 1000.0


@dataclasses.dataclass(frozen=True)
class Phase:
    """Send according to `fractions` for `duration_ms` (last phase may be
    open-ended: duration_ms = inf)."""

    duration_ms: float
    fractions: Tuple[float, ...]


def max_rate_for_profile(
    paths: Sequence[PathSpec], fractions: Sequence[float]
) -> float:
    """Largest aggregate rate R (bits/ms) such that p_i * R <= bw_i for all i
    (the bottleneck path saturates first)."""
    best = np.inf
    for p, spec in zip(fractions, paths):
        if p > 0:
            best = min(best, spec.rate_bits_per_ms / p)
    return 0.0 if np.isinf(best) else float(best)


def completion_time(
    message_mbit: float,
    paths: Sequence[PathSpec],
    schedule: Sequence[Phase],
) -> float:
    """Exact fluid completion time (ms) of a message under a phase schedule.

    Each phase sends at the profile's max feasible aggregate rate.  The
    message completes when the last *arriving* bit lands: for each path, its
    last-send instant plus its latency.
    """
    remaining = message_mbit * _BITS_PER_MBIT
    n = len(paths)
    t = 0.0
    last_send = np.full(n, -np.inf)  # time each path last carried traffic
    for phase in schedule:
        if remaining <= 1e-9:
            break
        rate = max_rate_for_profile(paths, phase.fractions)
        if rate <= 0.0:
            t += phase.duration_ms
            continue
        per_path = np.array(
            [f * rate for f in phase.fractions]
        )  # bits/ms on each path
        dur = min(phase.duration_ms, remaining / rate)
        for i in range(n):
            if per_path[i] > 0 and dur > 0:  # zero-length phases send nothing
                last_send[i] = t + dur
        remaining -= rate * dur
        t += dur
        if phase.duration_ms > dur:  # message finished inside this phase
            break
    if remaining > 1e-6:
        raise ValueError(
            f"schedule exhausted with {remaining:.1f} bits unsent; "
            "make the last phase open-ended"
        )
    arrivals = [
        last_send[i] + paths[i].latency_ms
        for i in range(n)
        if np.isfinite(last_send[i])
    ]
    return float(max(arrivals))


def static_profile_completion(
    message_mbit: float, paths: Sequence[PathSpec], fractions: Sequence[float]
) -> float:
    return completion_time(
        message_mbit, paths, [Phase(np.inf, tuple(fractions))]
    )


def optimal_two_path_schedule(
    message_mbit: float, paths: Sequence[PathSpec]
) -> Tuple[List[Phase], float]:
    """Closed-form optimal 2-phase schedule for two paths (§8 structure):
    phase 1 = both paths at full rate, phase 2 = low-latency path only.

    Let path h be the higher-latency one, l the lower.  With both at full
    rate from 0..T and then l alone, completion is
        max(T + lat_h, T + (M - (r_h+r_l) T)/r_l + lat_l)
    minimized where the two arms are equal (if the crossing is feasible).
    """
    M = message_mbit * _BITS_PER_MBIT
    (h, l) = (0, 1) if paths[0].latency_ms >= paths[1].latency_ms else (1, 0)
    r_h, r_l = paths[h].rate_bits_per_ms, paths[l].rate_bits_per_ms
    lat_h, lat_l = paths[h].latency_ms, paths[l].latency_ms
    r_tot = r_h + r_l
    # Equalize: lat_h = (M - r_tot*T)/r_l + lat_l  ->  T*
    T = (M - r_l * (lat_h - lat_l)) / r_tot
    T = float(np.clip(T, 0.0, M / r_tot))
    frac_both = (r_h / r_tot, r_l / r_tot) if h == 0 else (r_l / r_tot, r_h / r_tot)
    frac_low = tuple(1.0 if i == l else 0.0 for i in range(2))
    schedule = [Phase(T, frac_both), Phase(np.inf, frac_low)]
    return schedule, completion_time(message_mbit, paths, schedule)


def reverse_waterfill_schedule(
    message_mbit: float, paths: Sequence[PathSpec], deadline_ms: float
) -> float | None:
    """Feasibility: can the message complete by `deadline_ms` when every path
    i sends at full rate over [0, deadline - lat_i]?  Returns the achieved
    volume margin (bits) or None if infeasible.  Binary-searching this gives
    the n-path optimal completion time (see optimal_completion)."""
    M = message_mbit * _BITS_PER_MBIT
    vol = 0.0
    for spec in paths:
        window = max(deadline_ms - spec.latency_ms, 0.0)
        vol += spec.rate_bits_per_ms * window
    return (vol - M) if vol >= M else None


def optimal_completion(
    message_mbit: float, paths: Sequence[PathSpec], tol: float = 1e-6
) -> float:
    """Optimal completion time over ALL time-varying schedules (fluid bound):
    binary search the smallest deadline D such that sum_i r_i * max(0, D -
    lat_i) >= M.  The achieving schedule is 'every path sends full rate until
    D - lat_i then stops' — the n-path generalization of §8."""
    lo = min(p.latency_ms for p in paths)
    hi = lo + message_mbit * _BITS_PER_MBIT / min(
        p.rate_bits_per_ms for p in paths
    ) + 1.0
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if reverse_waterfill_schedule(message_mbit, paths, mid) is not None:
            hi = mid
        else:
            lo = mid
    return hi
