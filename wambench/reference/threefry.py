"""jax.random's legacy threefry-2x32 key stream in plain PyTorch.

Keys are int64 tensors ``[..., 2]`` holding uint32 values; every uint32
operation is done in int64 and masked.  Only what the sender's draws need:
`split`, `fold_in`, `uniform` and `randint`, each broadcasting over the
key's leading axes.
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def _block(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _hash(key, count):
    """threefry_2x32(key, count): the count halves hashed pairwise (an odd
    count padded with a zero), the outputs concatenated."""
    n = count.shape[-1]
    if n % 2:
        count = torch.cat([count, count.new_zeros(count.shape[:-1] + (1,))], -1)
    h = count.shape[-1] // 2
    y0, y1 = _block(key[..., 0:1], key[..., 1:2], count[..., :h], count[..., h:])
    return torch.cat([y0, y1], -1)[..., :n]


def key_of(k0: int, k1: int, device) -> torch.Tensor:
    return torch.tensor([k0 & M32, k1 & M32], dtype=torch.int64, device=device)


def split(key, num=2):
    out = _hash(key, torch.arange(2 * num, dtype=torch.int64, device=key.device))
    return out.reshape(key.shape[:-1] + (num, 2))


def fold_in(key, data):
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    return _hash(key, torch.stack([torch.zeros_like(data), data], -1))


def bits(key, shape):
    shape = tuple(shape)
    count = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    return _hash(key, count).reshape(key.shape[:-1] + shape)


def uniform(key, shape):
    """float32 in [0, 1): 23 random mantissa bits under exponent 0, less 1."""
    f = ((bits(key, shape) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min(f - 1.0, 0.0)


def randint(key, shape, lo, hi):
    """int32 in [lo, hi): two 32-bit draws combined modulo the span."""
    k = split(key, 2)
    a, b = bits(k[..., 0, :], shape), bits(k[..., 1, :], shape)
    span = hi - lo if hi > lo else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    off = ((((a % span) * mult) & M32) + b % span) & M32
    return (lo + off % span).to(torch.int32)
