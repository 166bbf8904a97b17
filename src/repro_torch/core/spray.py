"""Whack-a-Mole packet spraying (paper §4): spray keys and path selection.

For spray counter j and seed (sa, sb) the selection point is

  * PLAIN     : theta(j)
  * SHUFFLE_1 : theta(sa + j*sb mod m)
  * SHUFFLE_2 : (sa + sb*theta(j)) mod m
  * COMBINED  : SHUFFLE_1's key fed through SHUFFLE_2's post-mix with a
                second seed derived from the first

and the path is the smallest i with c(i-1) <= key < c(i).  Counters and
seeds are uint32 values held in int64 tensors; all arithmetic is exact.
"""
from __future__ import annotations

import dataclasses
import enum

import torch

from repro_torch.core.bitrev import theta
from repro_torch.random import M32, mul32

__all__ = ["SprayMethod", "SprayState", "spray_key", "select_path"]


class SprayMethod(enum.IntEnum):
    PLAIN = 0
    SHUFFLE_1 = 1
    SHUFFLE_2 = 2
    COMBINED = 3


@dataclasses.dataclass(frozen=True)
class SprayState:
    """Spray counters and seeds, one per flow (int64 holding uint32)."""

    j: torch.Tensor
    sa: torch.Tensor
    sb: torch.Tensor
    ell: int
    method: int

    @property
    def m(self) -> int:
        return 1 << self.ell


def spray_key(j, sa, sb, ell: int, method: int) -> torch.Tensor:
    """Selection points in [0, m) for counters j (seeds broadcast against j).

    Only the low ell bits of each product and sum survive the final mask,
    so operands are masked first and every product stays inside int64."""
    mask = (1 << ell) - 1
    j, sa, sb = j & M32, sa & M32, sb & M32
    if method == SprayMethod.PLAIN:
        return theta(j, ell)
    if method == SprayMethod.SHUFFLE_1:
        return theta((sa + (j & mask) * (sb & mask)) & mask, ell)
    if method == SprayMethod.SHUFFLE_2:
        return ((sa & mask) + (sb & mask) * theta(j, ell)) & mask
    if method == SprayMethod.COMBINED:
        sa2 = theta(sa, ell)
        sb2 = (mul32(sb, 0x9E37) | 1) & mask
        inner = theta((sa + (j & mask) * (sb & mask)) & mask, ell)
        return (sa2 + sb2 * inner) & mask
    raise ValueError(f"unknown spray method {method}")


def select_path(c: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Smallest i with key < c(i), as the count #{i : c(i) <= key}.

    ``c`` is ``[..., n]`` and ``key`` ``[..., B]`` with matching leading
    axes; returns int32 ``[..., B]``."""
    hits = c.to(torch.int64).unsqueeze(-2) <= key.to(torch.int64).unsqueeze(-1)
    return hits.sum(dim=-1, dtype=torch.int32)
