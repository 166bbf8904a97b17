"""Threefry-2x32 counter-based PRNG: jax.random's legacy key stream.

The golden traces and every run with moles draw from the non-partitionable
("original") threefry stream of `jax.random`.  This module reproduces it
bit for bit: keys are int64 tensors of shape ``[..., 2]`` holding uint32
values, and every uint32 operation is done in int64 and masked to 32 bits.

Functions broadcast over any leading key axes, so a whole horizon of
per-tick keys (or one key per flow) is one call:

  * ``PRNGKey(seed)``               -> ``[2]``
  * ``split(key, num)``             -> ``[..., num, 2]``
  * ``fold_in(key, data)``          -> ``[..., 2]`` (``data`` broadcasts)
  * ``random_bits(key, shape)``     -> uint32 values ``[..., *shape]``
  * ``uniform(key, shape)``         -> float32 in [0, 1)
  * ``randint(key, shape, lo, hi)`` -> int32 in [lo, hi)
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["PRNGKey", "split", "fold_in", "random_bits", "uniform", "randint",
           "threefry2x32", "M32", "mul32"]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 for uint32 values held in int64, without leaving
    the int64 range (the product is split on b's 16-bit halves)."""
    lo, hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block function (20 rounds), elementwise."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _hash(key: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """jax's ``threefry_2x32(key, count)``: the counts are cut into two
    halves (an odd count is padded with one 0), hashed pairwise, and the
    two output halves concatenated.  ``count`` is ``[..., N]`` and
    broadcasts against the key's leading axes."""
    n = count.shape[-1]
    if n % 2:
        pad = torch.zeros(count.shape[:-1] + (1,), dtype=count.dtype,
                          device=count.device)
        count = torch.cat([count, pad], dim=-1)
    half = count.shape[-1] // 2
    y0, y1 = threefry2x32(key[..., 0:1], key[..., 1:2],
                          count[..., :half], count[..., half:])
    return torch.cat([y0, y1], dim=-1)[..., :n]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """Legacy ``jax.random.PRNGKey(seed)``: ``[seed >> 32, seed & M32]``."""
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    count = torch.arange(2 * num, dtype=torch.int64, device=key.device)
    out = _hash(key, count)
    return out.reshape(key.shape[:-1] + (num, 2))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` may be a tensor of uint32 values
    whose shape broadcasts against the key's leading axes."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    count = torch.stack([torch.zeros_like(data), data], dim=-1)
    return _hash(key, count)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    shape = tuple(shape)
    size = math.prod(shape)
    count = torch.arange(size, dtype=torch.int64, device=key.device)
    return _hash(key, count).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 in [0, 1): 23 random mantissa bits under exponent 0, minus 1."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(fbits.view(torch.float32) - 1.0, 0.0)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32: two 32-bit draws combined modulo
    the span (jax's reduced-bias construction)."""
    keys = split(key, 2)
    hi = random_bits(keys[..., 0, :], shape)
    lo = random_bits(keys[..., 1, :], shape)
    span = maxval - minval if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    off = ((((hi % span) * mult) & M32) + lo % span) & M32
    return (minval + off % span).to(torch.int32)
