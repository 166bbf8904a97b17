"""Transformer building blocks: norms, RoPE, GQA attention, MLPs.

The port of the JAX package's `models/layers.py`, with its conventions:

* parameters are plain nested dicts of tensors, kept in the config's
  ``param_dtype`` (f32) and cast to the bf16 compute type where they are
  used; `model.compute_params` keeps those casts once, since the cast
  gives the same bits every time;
* activations are bf16; `rms_norm` and `rope` compute in f32 and cast back;
* attention goes through the port's kernels, `flash_attention` for a whole
  sequence and `flash_decode` for one token, which launch their CUDA
  kernels on the card and run their plain versions on the CPU;
  ``plain=True`` runs the plain versions on the card too (to hold the
  kernels to them).

The reference's sharding annotations are no-ops outside a mesh and have no
counterpart here.  `kv_quantize` / `kv_dequantize` are not ported: no
ported config sets ``kv_quant``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain, normalise

__all__ = [
    "COMPUTE_DTYPE",
    "rms_norm",
    "rope",
    "init_attention",
    "attention",
    "attention_decode",
    "init_mlp",
    "mlp",
]

COMPUTE_DTYPE = torch.bfloat16


def _cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


def _normal(shape, generator, std: float, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(std)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """Inverse frequencies, built in float64 numpy as the reference builds
    them, then f32 on ``device`` (kept: one host copy per shape, not per call)."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    return torch.as_tensor(freqs.astype(np.float32), device=device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, split-half rotation.  x: [..., S, H, D];
    positions: [..., S] (absolute)."""
    d = x.shape[-1]
    freqs = _rope_freqs(d, theta, x.device)
    ang = positions[..., :, None].float() * freqs          # [..., S, D/2]
    cos = torch.cos(ang)[..., :, None, :]                  # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def init_attention(generator: torch.Generator, cfg: ArchConfig, device,
                   stack: tuple = ()) -> dict:
    """Attention parameters, each with the leading dims ``stack``; the
    weights are drawn from ``generator`` (not jax.random's stream)."""
    d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = getattr(torch, cfg.param_dtype)
    std = float(1.0 / np.sqrt(d))
    p = {
        "wq": _normal((*stack, d, h, dh), generator, std, dt, device),
        "wk": _normal((*stack, d, kvh, dh), generator, std, dt, device),
        "wv": _normal((*stack, d, kvh, dh), generator, std, dt, device),
        "wo": _normal((*stack, h, dh, d), generator, float(std / np.sqrt(cfg.n_layers)), dt,
                      device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*stack, h, dh), dtype=dt, device=device)
        p["bk"] = torch.zeros((*stack, kvh, dh), dtype=dt, device=device)
        p["bv"] = torch.zeros((*stack, kvh, dh), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*stack, dh), dtype=dt, device=device)
        p["k_norm"] = torch.ones((*stack, dh), dtype=dt, device=device)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    d, h, k = w.shape
    return (x @ _cast(w).reshape(d, h * k)).unflatten(-1, (h, k))


def _qkv(p: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.qkv_bias:
        q = q + _cast(p["bq"])
        k = k + _cast(p["bk"])
        v = v + _cast(p["bv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("...hk,hkd->...d")`` as one matrix product."""
    h, k, d = wo.shape
    return out.flatten(-2) @ _cast(wo).reshape(h * k, d)


def attention(p: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, *,
              plain: bool = False):
    """Full-sequence causal self-attention (prefill).  x: [B, S, D]; returns
    ``(y [B, S, D], k, v)`` with k, v ``[B, S, KVH, Dh]`` for the cache (the
    reference computes them a second time; the result is the same)."""
    q, k, v = _qkv(p, cfg, x, positions)
    attend = flash_attention_plain if plain else flash_attention
    out = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=True, window=cfg.window).transpose(1, 2)  # [B, S, H, Dh]
    return _out(out, p["wo"]), k, v


def attention_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, pos: torch.Tensor,
                     cache: dict, kv_len: torch.Tensor, *, write_idx: torch.Tensor,
                     plain: bool = False) -> torch.Tensor:
    """One decode step against a (ring-buffer) KV cache ``{"k", "v"}`` of
    ``[B, L, KVH, Dh]``, which is updated in place at ``write_idx``.
    x: [B, 1, D]; pos, kv_len, write_idx: int[B].  Returns y [B, 1, D]."""
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    bidx = torch.arange(x.shape[0], device=x.device)
    cache["k"][bidx, write_idx] = k[:, 0]
    cache["v"][bidx, write_idx] = v[:, 0]
    if plain:
        o, _, l = flash_decode_plain(q[:, 0], cache["k"], cache["v"], kv_len)
        out = normalise(o, l, q.dtype)
    else:
        out = flash_decode(q[:, 0], cache["k"], cache["v"], kv_len)  # [B, H, Dh]
    return _out(out, p["wo"])[:, None]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def init_mlp(generator: torch.Generator, cfg: ArchConfig, device, stack: tuple = ()) -> dict:
    """SwiGLU MLP parameters, each with the leading dims ``stack``."""
    _check_mlp(cfg)
    d, f = cfg.d_model, cfg.d_ff
    dt = getattr(torch, cfg.param_dtype)
    std = float(1.0 / np.sqrt(d))
    return {
        "w_gate": _normal((*stack, d, f), generator, std, dt, device),
        "w_up": _normal((*stack, d, f), generator, std, dt, device),
        "w_down": _normal((*stack, f, d), generator, float(std / np.sqrt(cfg.n_layers)), dt,
                          device),
    }


def _check_mlp(cfg: ArchConfig) -> None:
    if cfg.mlp_kind != "swiglu":
        raise NotImplementedError(
            f"mlp_kind {cfg.mlp_kind!r} is not ported yet (ROADMAP queue 1, item 11)")


def mlp(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``silu(x w_gate) * (x w_up) w_down``.  The reference's
    ``jax.nn.silu`` on bf16 rounds every op to bf16 (``g * (1 / (1 +
    exp(-g)))``, measured bit for bit on the CPU); so does this."""
    _check_mlp(cfg)
    g = x @ _cast(p["w_gate"])
    u = x @ _cast(p["w_up"])
    h = g * (1.0 / (1.0 + torch.exp(-g))) * u
    return h @ _cast(p["w_down"])
