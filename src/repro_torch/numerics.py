"""Float association and rounding that match the jitted reference.

XLA on the CPU contracts a multiply that feeds an add inside one fused
loop into a fused multiply-add (one rounding), and it rewrites long sums
and prefix sums before it compiles them.  The port writes all of that out
explicitly, so that the CPU and the card give the reference's bits:

  * `fold_sum` adds as XLA:CPU's reduce does.  Up to 32 terms that is a
    left fold in ascending index order.  Above 32 XLA first sums windows
    of 32 terms (a reduce-window with "same" padding: the zeros it pads
    with split evenly between the two ends), each a left fold, and then
    sums the window results the same way.
  * `fold_cumsum` scans as XLA:CPU's cumulative sum does.  Up to 16 terms
    that is a left fold.  Above 16 XLA scans blocks of 16 (the last one
    padded with zeros), scans the blocks' totals the same way, and adds
    each block's exclusive prefix to the block's own scan.
  * `fma32` rounds ``a * b + c`` once, as the fused loop does.

None of them goes through `torch.sum` or `torch.cumsum`, whose order
differs by device.  The orders were measured with jax 0.9.0 on the CPU
(tests/test_torch_core.py pins them against jitted `jnp.sum` and
`jnp.cumsum` at 17 to 1,000 terms).
"""
from __future__ import annotations

import torch

__all__ = ["fold_sum", "fold_cumsum", "fma32", "SUM_WINDOW", "SCAN_BASE"]


SUM_WINDOW = 32  # XLA:CPU's reduce-window ahead of a long sum
SCAN_BASE = 16   # XLA:CPU's block length of a long cumulative sum


def _left_fold(x: torch.Tensor) -> torch.Tensor:
    """Sum along axis 0 in ascending index order."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def fold_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum along `dim` in XLA:CPU's order (see the module docstring)."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n <= SUM_WINDOW:
        return _left_fold(x)
    windows = -(-n // SUM_WINDOW)
    if n % SUM_WINDOW == 0:  # every window full: fold them side by side
        return fold_sum(_left_fold(x.unflatten(0, (windows, SUM_WINDOW)).transpose(0, 1)), 0)
    lo = (windows * SUM_WINDOW - n) // 2  # zeros padded in front
    # a padding zero adds nothing, so each window sums its slice of x
    parts = [_left_fold(x[max(0, w * SUM_WINDOW - lo):(w + 1) * SUM_WINDOW - lo])
             for w in range(windows)]
    return fold_sum(torch.stack(parts), 0)


def _left_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis as a left fold."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, dim=-1)


def fold_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis in XLA:CPU's order (see
    the module docstring)."""
    n = x.shape[-1]
    if n <= SCAN_BASE:
        return _left_scan(x)
    blocks = -(-n // SCAN_BASE)
    pad = x.new_zeros(x.shape[:-1] + (blocks * SCAN_BASE - n,))
    inner = _left_scan(torch.cat([x, pad], dim=-1).unflatten(-1, (blocks, SCAN_BASE)))
    totals = fold_cumsum(inner[..., -1])
    before = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]], dim=-1)
    return (inner + before.unsqueeze(-1)).flatten(-2)[..., :n]


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
