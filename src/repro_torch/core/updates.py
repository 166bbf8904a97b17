"""Dynamic path-profile updates (paper §7): embodiments 3 and 4, the two
the feedback controller calls.

Each maps ``(b, r, e) -> (b', r')`` in exact int32 arithmetic and keeps
sum(b) == m.  Tensors carry a leading batch axis: ``b``/``e`` are
``[..., n]`` and ``r`` is ``[...]``.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["update_embodiment3", "update_embodiment4"]


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
