"""Discrete path profiles (paper §3): n bins holding m = 2**ell balls.

``b`` is int32 ``[..., n]`` balls per bin and ``c`` its inclusive
cumulative form; a leading batch axis (one profile per flow) is allowed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["PathProfile", "make_profile", "cumulative", "from_cumulative",
           "uniform_profile", "quantize_counts", "quantize_profile", "validate_profile"]


@dataclasses.dataclass(frozen=True)
class PathProfile:
    b: torch.Tensor  # int32[..., n]
    c: torch.Tensor  # int32[..., n] inclusive cumulative counts
    ell: int

    @property
    def n(self) -> int:
        return int(self.b.shape[-1])

    @property
    def m(self) -> int:
        return 1 << self.ell

    @property
    def fractions(self) -> np.ndarray:
        return self.b.cpu().numpy().astype(np.float64) / self.m


def cumulative(b: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(b, dim=-1, dtype=torch.int32)


def from_cumulative(c: torch.Tensor) -> torch.Tensor:
    """b(i) = c(i) - c(i-1), with c(-1) = 0."""
    c = c.to(torch.int32)
    return torch.diff(c, dim=-1, prepend=torch.zeros_like(c[..., :1]))


def make_profile(b: torch.Tensor, ell: int) -> PathProfile:
    b = b.to(torch.int32)
    return PathProfile(b=b, c=cumulative(b), ell=ell)


def uniform_profile(n: int, ell: int, device=None) -> PathProfile:
    """As-even-as-possible integer split of m balls over n bins."""
    base, extra = divmod(1 << ell, n)
    b = torch.full((n,), base, dtype=torch.int32, device=device)
    b[:extra] += 1  # built on the device: no copy from the host
    return make_profile(b, ell)


def quantize_counts(p, ell: int) -> np.ndarray:
    """Largest-remainder quantization of fractions to m integer balls."""
    p = np.asarray(p, dtype=np.float64)
    if p.ndim != 1 or p.size == 0:
        raise ValueError("profile must be a non-empty 1-D array")
    if np.any(p < 0):
        raise ValueError("profile fractions must be nonnegative")
    s = p.sum()
    if s <= 0:
        raise ValueError("profile must have positive mass")
    scaled = p / s * (1 << ell)
    base = np.floor(scaled).astype(np.int64)
    leftover = int((1 << ell) - base.sum())
    if leftover > 0:
        order = np.argsort(-(scaled - base), kind="stable")
        base[order[:leftover]] += 1
    return base.astype(np.int32)


def quantize_profile(p, ell: int, device=None) -> PathProfile:
    return make_profile(torch.as_tensor(quantize_counts(p, ell), device=device),
                        ell)


def validate_profile(profile: PathProfile) -> None:
    """Host-side invariant check of a 1-D profile (raises on violation)."""
    b = profile.b.cpu().numpy()
    c = profile.c.cpu().numpy()
    if b.ndim != 1:
        raise ValueError("b must be 1-D")
    if np.any(b < 0):
        raise ValueError(f"negative bin counts: {b}")
    if int(b.sum()) != profile.m:
        raise ValueError(f"sum(b)={int(b.sum())} != m={profile.m}")
    if not np.array_equal(np.cumsum(b), c):
        raise ValueError("cumulative array out of sync with bins")
