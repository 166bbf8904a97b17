"""Dynamic path-profile updates (paper §7): embodiments 1-4.

Each maps ``(b, r, removal) -> (b', r')`` in exact int32 arithmetic and
keeps sum(b) == m, with a persistent round-robin residual index r.
Tensors may carry leading batch axes: ``b``/``e`` are ``[..., n]`` and
``r`` is ``[...]``.  The feedback controller calls embodiments 3 and 4.
``ref_embodiment1..4`` are the paper's scalar pseudocode in numpy int64,
the oracles the vectorised updates are held to.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["update_embodiment1", "update_embodiment2", "update_embodiment3",
           "update_embodiment4", "ref_embodiment1", "ref_embodiment2",
           "ref_embodiment3", "ref_embodiment4"]


def _floordiv(a: torch.Tensor, b) -> Tuple[torch.Tensor, torch.Tensor]:
    q = torch.div(a, b, rounding_mode="floor")
    return q, a - q * b


def _residuals_all_bins(b, r, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """Add one ball to each of y bins walking round-robin from r (y < n)."""
    n = b.shape[-1]
    steps = torch.arange(n, device=b.device)
    walk = (r.unsqueeze(-1) + steps) % n
    add = (steps < y.unsqueeze(-1)).to(torch.int32)
    b = b.scatter_add(-1, walk, add)  # walk is a permutation: no collisions
    return b, ((r + y) % n).to(torch.int32)


def _residuals_kbar_only(b, r, y, in_kbar) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hand one ball to each of the first y Kbar bins met walking from r;
    the new r is one past the y-th hit (unchanged when y == 0)."""
    n = b.shape[-1]
    walk = (r.unsqueeze(-1) + torch.arange(n, device=b.device)) % n
    kbar_on_walk = torch.gather(in_kbar, -1, walk).to(torch.int32)
    rank = torch.cumsum(kbar_on_walk, dim=-1, dtype=torch.int32)
    add = ((kbar_on_walk == 1) & (rank <= y.unsqueeze(-1))).to(torch.int32)
    b = b.scatter_add(-1, walk, add)  # walk is a permutation: no collisions
    is_yth = ((rank == y.unsqueeze(-1)) & (kbar_on_walk == 1)).to(torch.int32)
    yth_off = torch.argmax(is_yth, dim=-1).to(torch.int32)
    new_r = torch.where(y > 0, (r + yth_off + 1) % n, r)
    return b, new_r.to(torch.int32)


def update_embodiment1(b, r, j, e_j):
    """Remove e(j) balls from bin j (in [0, n)); redistribute evenly over
    all bins."""
    n = b.shape[-1]
    x, y = _floordiv(e_j, n)
    b = (b + x.unsqueeze(-1)).scatter_add(
        -1, j.to(torch.int64).unsqueeze(-1), -e_j.unsqueeze(-1))
    return _residuals_all_bins(b.to(torch.int32), r, y)


def update_embodiment2(b, r, e):
    """Remove e(i) from each bin; redistribute evenly over all bins."""
    n = b.shape[-1]
    x, y = _floordiv(e.sum(-1, dtype=torch.int32), n)
    return _residuals_all_bins((b - e + x.unsqueeze(-1)).to(torch.int32), r, y)


def update_embodiment3(b, r, e):
    """Remove e(i) from bins in K = {e > 0}; redistribute evenly over Kbar."""
    in_kbar = e == 0
    kbar = in_kbar.sum(-1, dtype=torch.int32)
    tot = e.sum(-1, dtype=torch.int32)
    x = torch.div(tot, kbar, rounding_mode="floor")
    y = tot - x * kbar
    b = b - e + torch.where(in_kbar, x.unsqueeze(-1), 0).to(torch.int32)
    return _residuals_kbar_only(b, r, y, in_kbar)


def update_embodiment4(b, r, e):
    """Remove e(i) from bins in K; redistribute proportionally over all bins,
    leftover balls evenly over Kbar."""
    m = b.sum(-1, dtype=torch.int32, keepdim=True)
    in_kbar = e == 0
    kbar = in_kbar.sum(-1, dtype=torch.int32)
    denom = m - e.sum(-1, dtype=torch.int32, keepdim=True)
    scaled = (b - e) * m
    b_new = torch.div(scaled, denom, rounding_mode="floor")
    rem = scaled - b_new * denom
    leftover = torch.div(rem.sum(-1, dtype=torch.int32, keepdim=True), denom,
                         rounding_mode="floor").squeeze(-1)
    x = torch.div(leftover, kbar, rounding_mode="floor")
    y = leftover - x * kbar
    b_new = b_new + torch.where(in_kbar, x.unsqueeze(-1), 0).to(torch.int32)
    return _residuals_kbar_only(b_new.to(torch.int32), r, y, in_kbar)


# The paper's pseudocode, literally (scalar loops, numpy int64).


def _ref_residuals_all(b, r, y):
    for _ in range(int(y)):
        b[r] += 1
        r = (r + 1) % b.shape[0]
    return b, r


def _ref_residuals_kbar(b, r, y, e):
    n = b.shape[0]
    while y > 0:
        if e[r] == 0:
            b[r] += 1
            y -= 1
        r = (r + 1) % n
    return b, r


def ref_embodiment1(b, r, j, e_j):
    b = np.array(b, dtype=np.int64)
    n = b.shape[0]
    x, y = int(e_j) // n, int(e_j) % n
    for i in range(n):
        if i != j:
            b[i] += x
    b[j] = b[j] - int(e_j) + x
    return _ref_residuals_all(b, int(r), y)


def ref_embodiment2(b, r, e):
    b = np.array(b, dtype=np.int64)
    e = np.asarray(e, dtype=np.int64)
    n = b.shape[0]
    tot = int(e.sum())
    x, y = tot // n, tot % n
    for i in range(n):
        b[i] = b[i] - e[i] + x
    return _ref_residuals_all(b, int(r), y)


def ref_embodiment3(b, r, e):
    b = np.array(b, dtype=np.int64)
    e = np.asarray(e, dtype=np.int64)
    n = b.shape[0]
    kbar = [i for i in range(n) if e[i] == 0]
    tot = int(e.sum())
    x, y = tot // len(kbar), tot % len(kbar)
    for i in range(n):
        if e[i] > 0:
            b[i] -= e[i]
        else:
            b[i] += x
    return _ref_residuals_kbar(b, int(r), y, e)


def ref_embodiment4(b, r, e):
    b = np.array(b, dtype=np.int64)
    e = np.asarray(e, dtype=np.int64)
    n = b.shape[0]
    m = int(b.sum())
    kbar = [i for i in range(n) if e[i] == 0]
    denom = m - int(e.sum())
    rem = np.zeros(n, dtype=np.int64)
    for i in range(n):
        scaled = (b[i] - e[i]) * m
        b[i] = scaled // denom
        rem[i] = scaled % denom
    leftover = int(rem.sum()) // denom
    x, y = leftover // len(kbar), leftover % len(kbar)
    for i in kbar:
        b[i] += x
    return _ref_residuals_kbar(b, int(r), y, e)
