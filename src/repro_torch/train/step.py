"""Serving step builders: the port of `build_prefill_step` and
`build_decode_step` of the JAX package's `train/step.py`.

Each step returns the greedy next token (argmax, the first index on ties,
as `jnp.argmax`), the updated cache and, beside them, the step's logits,
so that a caller can hold two runs to each other.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M

__all__ = ["greedy", "build_prefill_step", "build_decode_step"]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def build_prefill_step(cfg: ArchConfig, *, plain: bool = False, routes=None):
    """prefill(params, batch, cache) -> (next int32[B], cache, logits f32[B, V]).
    ``batch`` holds ``tokens`` and the frontend's ``patches`` or ``frames``
    (`models.model.prefill`); ``routes`` records or replays the MoE choices."""

    def prefill_step(params, batch, cache):
        logits, cache = M.prefill(params, cfg, batch, cache, plain=plain, routes=routes)
        return greedy(logits), cache, logits

    return prefill_step


def build_decode_step(cfg: ArchConfig, *, plain: bool = False, routes=None):
    """decode(params, tokens [B, 1], pos [B], cache) -> (next int32[B], cache,
    logits f32[B, V])."""

    def decode_step(params, tokens, pos, cache):
        logits, cache = M.decode_step(params, cfg, tokens, pos, cache, plain=plain,
                                      routes=routes)
        return greedy(logits), cache, logits

    return decode_step
