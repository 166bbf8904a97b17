"""Float association and rounding that match the jitted reference.

XLA on the CPU sums a short axis as a left fold and contracts a multiply
that feeds an add inside one fused loop into a fused multiply-add (one
rounding).  The port writes both out explicitly, so that the CPU and the
card give the reference's bits:

  * `fold_sum` / `fold_cumsum` add in ascending index order, never through
    `torch.sum` or `torch.cumsum` (whose order differs by device);
  * `fma32` rounds ``a * b + c`` once, as the fused loop does.
"""
from __future__ import annotations

import torch

__all__ = ["fold_sum", "fold_cumsum", "fma32"]


def fold_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum along `dim` as a left fold in ascending index order."""
    x = x.movedim(dim, 0)
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def fold_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis as a left fold."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, dim=-1)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with a single rounding.

    The product is exact in float64 and the sum is made round-to-odd there
    (TwoSum gives the sign of the error), so the final rounding to float32
    is the correctly rounded fused result: no double-rounding error."""
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = s.view(torch.int64)
    odd_fix = (err != 0) & ((bits & 1) == 0)
    away = (err > 0) == (s > 0)
    bits = torch.where(odd_fix, torch.where(away, bits + 1, bits - 1), bits)
    return bits.view(torch.float64).to(torch.float32)
