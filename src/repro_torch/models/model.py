"""Top-level model API of the port for the dense decoder-only models.

  init_params / compute_params   - parameter tree, and its bf16 compute copy
  make_cache                     - zeroed KV caches for prefill + decode
  prefill / decode_step          - serving paths; caches updated in place

The port of the JAX package's `models/model.py` for the dense decoder
stacks.  `train_loss`, the encoder (enc-dec) and the vision projector are
not ported yet and raise `NotImplementedError`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import COMPUTE_DTYPE, rms_norm
from repro_torch.models.transformer import (
    check_stack,
    init_stack,
    init_stack_cache,
    run_stack_decode,
    run_stack_prefill,
)

__all__ = ["init_params", "compute_params", "make_cache", "prefill", "decode_step"]

# leaves the reference casts to bf16 where it uses them; the norm scales,
# the embedding table and the head are used in f32
_BF16_LEAVES = frozenset({"wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_gate", "w_up", "w_down"})


def _check_family(cfg: ArchConfig) -> None:
    if cfg.is_encdec or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the encoder and modality frontends are not ported yet "
            f"(ROADMAP queue 1, item 11: the rest of the model zoo)")
    check_stack(cfg)


def init_params(generator: torch.Generator, cfg: ArchConfig) -> dict:
    """Parameter tree in ``cfg.param_dtype`` on the generator's device, drawn
    from ``generator`` (the layout of the reference's tree, not its
    numbers: jax.random's stream is not reproduced)."""
    _check_family(cfg)
    device = generator.device
    dt = getattr(torch, cfg.param_dtype)
    d, v = cfg.d_model, cfg.vocab_size
    std = float(1.0 / np.sqrt(d))
    p: Dict[str, object] = {
        "embed": torch.randn((v, d), generator=generator, dtype=dt, device=device).mul_(std),
        "final_norm": torch.ones((d,), dtype=dt, device=device),
        "layers": init_stack(generator, cfg, device),
    }
    if not cfg.tie_embeddings:
        p["head"] = torch.randn((d, v), generator=generator, dtype=dt, device=device).mul_(std)
    return p


def compute_params(params: dict) -> dict:
    """The tree with a bf16 copy of every leaf the reference casts to bf16
    where it uses it (the cast gives the same bits each time); the other
    leaves are shared, not copied."""
    out = {}
    for key, value in params.items():
        if isinstance(value, dict):
            out[key] = compute_params(value)
        elif key in _BF16_LEAVES:
            out[key] = value.to(COMPUTE_DTYPE)
        else:
            out[key] = value
    return out


def make_cache(cfg: ArchConfig, batch: int, seq_len: int, *, device="cuda") -> dict:
    """Zeroed KV caches for ``batch`` sequences of up to ``seq_len`` tokens
    (a sliding window bounds the capacity)."""
    _check_family(cfg)
    return init_stack_cache(cfg, batch, seq_len, resolve_device(device))


def _embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens].to(COMPUTE_DTYPE)


def _unembed(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, then the head in f32 (as the reference: ``x.astype(f32)
    @ w.astype(f32)``)."""
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    w = p["head"] if "head" in p else p["embed"].T
    return x.float() @ w.float()


def prefill(p: dict, cfg: ArchConfig, batch: Dict[str, torch.Tensor], cache: dict, *,
            plain: bool = False):
    """Run the full prompt ``batch["tokens"]`` [B, S]; returns (last-position
    logits f32[B, V], cache).  ``plain=True`` runs the attention kernels'
    plain versions."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(p, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
    x, cache = run_stack_prefill(p["layers"], cfg, x, positions, cache, plain=plain)
    return _unembed(p, cfg, x[:, -1:])[:, 0], cache


def decode_step(p: dict, cfg: ArchConfig, tokens: torch.Tensor, pos: torch.Tensor,
                cache: dict, *, plain: bool = False):
    """One token for every sequence: tokens [B, 1], pos int[B] (absolute).
    Returns (logits f32[B, V], cache)."""
    _check_family(cfg)
    x = _embed_tokens(p, tokens)
    x, cache = run_stack_decode(p["layers"], cfg, x, pos, cache, plain=plain)
    return _unembed(p, cfg, x)[:, 0], cache
