"""Bit-reversal permutation theta(j, ell) (paper §4), on int64 tensors that
hold uint32 values."""
from __future__ import annotations

import torch

__all__ = ["bit_reverse32", "theta", "theta_inverse"]

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F
_M8 = 0x00FF00FF


def bit_reverse32(x: torch.Tensor) -> torch.Tensor:
    """Reverse all 32 bits of each uint32 value (held in int64)."""
    x = ((x >> 1) & _M1) | ((x & _M1) << 1)
    x = ((x >> 2) & _M2) | ((x & _M2) << 2)
    x = ((x >> 4) & _M4) | ((x & _M4) << 4)
    x = ((x >> 8) & _M8) | ((x & _M8) << 8)
    return ((x >> 16) | (x << 16)) & 0xFFFFFFFF


def theta(j: torch.Tensor, ell: int) -> torch.Tensor:
    """Reverse the ell least significant bits of j: values in [0, 2**ell).

    >>> int(theta(torch.tensor(249), 10))
    636
    """
    if not (1 <= ell <= 32):
        raise ValueError(f"ell must be in [1, 32], got {ell}")
    mask = (1 << ell) - 1
    return bit_reverse32(j & mask) >> (32 - ell)


def theta_inverse(k: torch.Tensor, ell: int) -> torch.Tensor:
    """theta is an involution on ell-bit integers: theta(theta(k)) == k."""
    return theta(k, ell)
