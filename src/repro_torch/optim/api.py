"""Optimizer facade, learning-rate schedule and gradient compression
hooks: the port of the JAX package's `optim/api.py`."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.numerics import fma32
from repro_torch.optim.adafactor import AdafactorConfig, adafactor_init, adafactor_update
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

__all__ = ["Optimizer", "make_optimizer", "cosine_schedule", "compress_int8",
           "decompress_int8", "topk_sparsify"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable  # (grads, state, params, lr_scale) -> (params, state), in place


def make_optimizer(name: str, **overrides) -> Optimizer:
    if name == "adamw":
        cfg = AdamWConfig(**overrides)
        return Optimizer("adamw", adamw_init,
                         lambda g, s, p, lr_scale=1.0: adamw_update(g, s, p, cfg, lr_scale))
    if name == "adafactor":
        cfg = AdafactorConfig(**overrides)
        return Optimizer("adafactor", adafactor_init,
                         lambda g, s, p, lr_scale=1.0: adafactor_update(g, s, p, cfg, lr_scale))
    raise ValueError(f"unknown optimizer {name}")


def _recip(n: int) -> float:
    return float(np.float32(1.0 / n))


def cosine_schedule(step: torch.Tensor, *, warmup: int = 100, total: int = 10_000,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``floor``; f32, on step's device.
    As XLA compiles the reference's: a division by a constant is a product
    with its f32 reciprocal, and the cosine's scale-and-shift one fused
    multiply-add."""
    s = step.float()
    warm = torch.clamp(s * _recip(max(warmup, 1)), max=1.0)
    prog = torch.clamp((s - warmup) * _recip(max(total - warmup, 1)), 0.0, 1.0)
    half = torch.full_like(s, (1 - floor) * 0.5)
    cos = fma32(half, 1 + torch.cos(math.pi * prog), torch.full_like(s, floor))
    return warm * cos


# gradient compression hooks (the cross-pod reduction path, where the
# multipath transport carries the traffic and every byte counts)
_INV_127 = float(np.float32(1.0 / 127.0))


def compress_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization: (q int8, scale f32 0-d).  The
    scale is the max times f32(1 / 127), as XLA folds the reference's
    division by 127."""
    scale = torch.clamp(x.abs().max(), min=1e-12) * _INV_127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_sparsify(x: torch.Tensor, frac: float = 0.01):
    """The top-|frac| magnitude entries (flat): (values, indices), the lower
    index first among equal magnitudes (``lax.top_k``'s order)."""
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return flat[idx], idx
