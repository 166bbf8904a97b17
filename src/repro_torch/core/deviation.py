"""Spray deviation measurement (paper §9 definitions).

For a set A of consecutive balls (selection units) and spray counter sequence
{j, ..., j'}:

  disc(A, j, j')   = (#selections landing in A) - |A|/m * (j'-j+1)
  maxdisc(A, j)    = max_{j'>=j} max(0, disc(A, j, j'))
  mindisc(A, j)    = min_{j'>=j} min(0, disc(A, j, j'))
  dev(A)           = max_j (maxdisc(A, j) - mindisc(A, j))

All spray methods are periodic with period m = 2**ell (the counter enters mod
2**ell), and one full period selects every ball exactly once, contributing
exactly zero discrepancy.  Hence suprema over unbounded j' are attained with
j' in [j, j+m), and the max over start times j is attained for j in [0, m).
We therefore compute deviations EXACTLY with integer arithmetic over a 2m
window:  m * disc = m * hits - |A| * X  (returned as integers; callers divide
by m for the real-valued deviation).

Path i of a profile owns the consecutive ball interval [c(i-1), c(i)) — the
"deviation of path i" in §4 is the deviation of that interval.

Host numpy over the port's exact integer `spray_key` (CPU tensors).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.profile import PathProfile
from repro_torch.core.spray import spray_key

__all__ = [
    "spray_keys_np",
    "interval_discrepancy_scaled",
    "interval_deviation",
    "path_deviations",
    "deviation_from_start",
    "max_deviation",
]


def spray_keys_np(
    ell: int, method: int, sa: int, sb: int, start: int, count: int
) -> np.ndarray:
    """Selection points for counters start..start+count-1 (host numpy)."""
    js = torch.arange(start, start + count, dtype=torch.int64) % (1 << ell)
    keys = spray_key(js, torch.tensor(sa), torch.tensor(sb), ell, method)
    return keys.numpy()


def _hits(keys: np.ndarray, lo: int, hi: int) -> np.ndarray:
    return ((keys >= lo) & (keys < hi)).astype(np.int64)


def interval_discrepancy_scaled(
    ell: int, method: int, sa: int, sb: int, lo: int, hi: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact m-scaled (maxdisc, mindisc) for ball interval [lo, hi), for every
    start j in [0, m).

    Returns integer arrays (scaled_maxdisc[j], scaled_mindisc[j]) where the
    real deviation quantities are these divided by m.
    """
    m = 1 << ell
    size = hi - lo
    keys = spray_keys_np(ell, method, sa, sb, 0, 2 * m)
    h = _hits(keys, lo, hi)
    # prefix[k] = hits in [0, k)
    prefix = np.concatenate([[0], np.cumsum(h)])
    js = np.arange(m)
    lens = np.arange(1, m + 1)
    # scaled_disc[j, w] = m * (prefix[j+w] - prefix[j]) - size * w  (w = window len)
    windows = prefix[js[:, None] + lens[None, :]] - prefix[js[:, None]]
    scaled = m * windows - size * lens[None, :]
    smax = np.maximum(scaled.max(axis=1), 0)
    smin = np.minimum(scaled.min(axis=1), 0)
    return smax, smin


def interval_deviation(
    ell: int, method: int, sa: int, sb: int, lo: int, hi: int
) -> float:
    """dev([lo, hi)) — exact, returned as a float (scaled/m)."""
    smax, smin = interval_discrepancy_scaled(ell, method, sa, sb, lo, hi)
    return float((smax - smin).max()) / (1 << ell)


def deviation_from_start(
    ell: int, method: int, sa: int, sb: int, lo: int, hi: int, j: int
) -> float:
    """maxdisc(A, j) - mindisc(A, j) for A = [lo, hi) at a fixed start j
    (this is the §4 worked example's per-path 'discrepancy starting at t')."""
    smax, smin = interval_discrepancy_scaled(ell, method, sa, sb, lo, hi)
    m = 1 << ell
    return float(smax[j % m] - smin[j % m]) / m


def path_deviations(
    profile: PathProfile, method: int, sa: int, sb: int, start: int | None = None
) -> np.ndarray:
    """Per-path deviations; at a fixed start j if given, else sup over starts."""
    c = np.concatenate([[0], profile.c.cpu().numpy()])
    out = np.zeros(profile.n)
    for i in range(profile.n):
        lo, hi = int(c[i]), int(c[i + 1])
        if lo == hi:
            out[i] = 0.0
            continue
        if start is None:
            out[i] = interval_deviation(profile.ell, method, sa, sb, lo, hi)
        else:
            out[i] = deviation_from_start(
                profile.ell, method, sa, sb, lo, hi, start
            )
    return out


def max_deviation(profile: PathProfile, method: int, sa: int, sb: int) -> float:
    """Worst per-path deviation for the profile (compare to ell / 2*ell)."""
    return float(path_deviations(profile, method, sa, sb).max())
