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
counterpart here.  With ``kv_quant`` the KV caches hold int8 entries and
f32 scales (`kv_quantize`); a decode step dequantizes the whole cache to
bf16 and runs `flash_decode` over it, as the reference does.

bf16 elementwise activations follow the reference's compiled rounding on
the CPU: XLA rounds every op of `jax.nn.silu` and `jax.nn.gelu` to bf16,
and gelu's constants too (measured op by op against the jitted reference).
"""
from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch
from torch.utils.checkpoint import CheckpointPolicy

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
    "cross_attention_decode",
    "init_mlp",
    "mlp",
    "ffn_hidden",
    "checkpoint_name",
    "save_only_these_names",
    "matmul",
    "gelu",
    "sigmoid",
    "silu",
    "kv_quantize",
    "kv_dequantize",
]

COMPUTE_DTYPE = torch.bfloat16


def _cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched too) of bf16 operands, a bf16 result.  On the CPU
    the product is taken in f32 and rounded once, as the reference's
    compiled CPU program computes a bf16 dot (torch's bf16 CPU kernels
    round an occasional sum to the other neighbour); on the card the bf16
    tensor-core product, which accumulates in f32 too."""
    if a.device.type == "cpu":
        return (a.float() @ b.float()).to(a.dtype)
    return a @ b


def _normal(shape, generator, std: float, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(std)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` on bf16 as the reference's compiled program rounds
    it: ``1 / (1 + exp(-x))``, every op rounded to bf16."""
    return 1.0 / (1.0 + torch.exp(-x))


class _SiLU(torch.autograd.Function):
    """`silu`, with the backward of the reference's compiled ``jax.grad``:
    ``g s + (x g) (s (1 - s))``, every op in the input's dtype (bit for bit
    on every bf16 value; autograd's backward of the forward's ops rounds
    otherwise in ~3% of them)."""

    @staticmethod
    def forward(ctx, x):
        s = sigmoid(x)
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (x * g) * (s * (1.0 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` on bf16 as the reference's compiled program rounds
    it: ``x * sigmoid(x)``, every op rounded to bf16; its gradient as the
    reference's (`_SiLU`)."""
    return _SiLU.apply(x)


# jax.nn.gelu's constants as XLA folds them into a bf16 program
_GELU_CUBIC = float(torch.tensor(0.044715).to(COMPUTE_DTYPE))
_GELU_SCALE = float(torch.tensor(np.sqrt(2 / np.pi)).to(COMPUTE_DTYPE))


def _gelu_half(x: torch.Tensor) -> torch.Tensor:
    """gelu's factor ``0.5 * (1 + tanh(c * (x + k * x**3)))``, every op in bf16."""
    inner = x + (x * x * x) * _GELU_CUBIC
    return (torch.tanh(inner * _GELU_SCALE) + 1.0) * 0.5


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh approximation) on bf16 as the
    reference's compiled program rounds it: ``x * (0.5 * (1 + tanh(c * (x +
    k * x**3))))`` with bf16 constants c, k and every op rounded to bf16
    (bit for bit on every bf16 value but denormals, which XLA flushes)."""
    return x * _gelu_half(x)


_REGION = threading.local()  # the open `checkpoint_name` region's name, per thread


@contextlib.contextmanager
def checkpoint_name(name: str):
    """The ops run inside make the tensor that the reference names ``name``
    (``jax.ad_checkpoint.checkpoint_name``).  A checkpointed sublayer whose
    remat policy keeps ``name`` (`save_only_these_names`) holds their
    outputs through its backward instead of recomputing them.  Keep the
    region to the op that makes the tensor: on the card a product or an
    elementwise op is one op; on the CPU `matmul` is its f32 casts, the
    product and the rounding, all kept."""
    outer = getattr(_REGION, "name", None)
    _REGION.name = name
    try:
        yield
    finally:
        _REGION.name = outer


def save_only_these_names(*names: str):
    """A selective-checkpoint policy (for
    `torch.utils.checkpoint.create_selective_checkpoint_contexts`), the
    counterpart of ``jax.checkpoint_policies.save_only_these_names``: the
    ops run in a `checkpoint_name` region of one of ``names`` are kept,
    every other op is recomputed."""
    def policy(ctx, op, *args, **kwargs):
        if getattr(_REGION, "name", None) in names:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


_INV_127 = float(np.float32(1.0 / 127.0))


def kv_quantize(x: torch.Tensor):
    """Symmetric int8 per-(token, head) quantization of a KV entry:
    ``x [..., D] -> (q int8[..., D], scale f32[...])``.  ``torch.round``
    rounds half to even, as ``jnp.round`` does; the scale is the max times
    f32(1 / 127), as XLA folds the reference's division by 127."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) * _INV_127, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(COMPUTE_DTYPE)


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
    return matmul(x, _cast(w).reshape(d, h * k)).unflatten(-1, (h, k))


def _query(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The query projection alone, before qk-norm and RoPE (cross-attention
    decode takes it so)."""
    q = _project(x, p["wq"])
    return q + _cast(p["bq"]) if cfg.qkv_bias else q


def _qkv(p: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, *,
         rotary: bool = True, with_kv: bool = True):
    """q, k, v ``[B, S, heads, Dh]``; with ``with_kv=False`` k and v are
    None (cross-attention reads the encoder's)."""
    q = _query(p, cfg, x)
    k = v = None
    if with_kv:
        k = _project(x, p["wk"])
        v = _project(x, p["wv"])
        if cfg.qkv_bias:
            k = k + _cast(p["bk"])
            v = v + _cast(p["bv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = None if k is None else rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rotary:
        q = rope(q, positions, cfg.rope_theta)
        k = None if k is None else rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("...hk,hkd->...d")`` as one matrix product."""
    h, k, d = wo.shape
    return matmul(out.flatten(-2), _cast(wo).reshape(h * k, d))


def attention(p: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, *,
              causal: bool = True, rotary: bool = True, kv=None, plain: bool = False):
    """Full-sequence attention (prefill, the encoder).  x: [B, S, D]; returns
    ``(y [B, S, D], k, v)`` with k, v ``[B, S, KVH, Dh]`` for the cache (the
    reference computes them a second time; the result is the same).  With
    ``kv = (k, v)`` it is cross-attention over those keys and values
    (``[B, S_kv, KVH, Dh]``), never causal, and only q is projected."""
    q, k, v = _qkv(p, cfg, x, positions, rotary=rotary, with_kv=kv is None)
    if kv is not None:
        k, v = kv
        causal = False
    attend = flash_attention_plain if plain else flash_attention
    out = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=causal, window=cfg.window).transpose(1, 2)  # [B, S, H, Dh]
    return _out(out, p["wo"]), k, v


def _decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: torch.Tensor, *,
                   plain: bool) -> torch.Tensor:
    """q [B, H, Dh] over the cache k, v [B, L, KVH, Dh]: `flash_decode`, or
    its plain version normalised as the wrapper does."""
    if plain:
        o, _, l = flash_decode_plain(q, k, v, kv_len)
        return normalise(o, l, q.dtype)
    return flash_decode(q, k, v, kv_len)


def attention_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, pos: torch.Tensor,
                     cache: dict, kv_len: torch.Tensor, *, write_idx: torch.Tensor,
                     plain: bool = False) -> torch.Tensor:
    """One decode step against a (ring-buffer) KV cache ``{"k", "v"}`` of
    ``[B, L, KVH, Dh]``, which is updated in place at ``write_idx``.
    x: [B, 1, D]; pos, kv_len, write_idx: int[B].  Returns y [B, 1, D].
    A quantized cache (int8 ``k``, ``v`` and f32 ``k_scale``, ``v_scale``
    ``[B, L, KVH]``) takes the new entry quantized and is read dequantized
    whole, as the reference reads it."""
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    bidx = torch.arange(x.shape[0], device=x.device)
    if "k_scale" in cache:
        for name, t in (("k", k), ("v", v)):
            qt, st = kv_quantize(t[:, 0])
            cache[name][bidx, write_idx] = qt
            cache[f"{name}_scale"][bidx, write_idx] = st
        ck = kv_dequantize(cache["k"], cache["k_scale"])
        cv = kv_dequantize(cache["v"], cache["v_scale"])
    else:
        cache["k"][bidx, write_idx] = k[:, 0]
        cache["v"][bidx, write_idx] = v[:, 0]
        ck, cv = cache["k"], cache["v"]
    out = _decode_attend(q[:, 0], ck, cv, kv_len, plain=plain)  # [B, H, Dh]
    return _out(out, p["wo"])[:, None]


def cross_attention_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict, *,
                           plain: bool = False) -> torch.Tensor:
    """One token's cross-attention over the encoder's cached ``{"k", "v"}``
    ``[B, S_enc, KVH, Dh]``, every slot valid; no RoPE, no qk-norm (as the
    reference's decode).  x: [B, 1, D]; returns y [B, 1, D]."""
    q = _query(p, cfg, x)
    B, enc_len = x.shape[0], cache["k"].shape[1]
    lens = torch.full((B,), enc_len, dtype=torch.int32, device=x.device)
    out = _decode_attend(q[:, 0], cache["k"], cache["v"], lens, plain=plain)
    return _out(out, p["wo"])[:, None]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def init_mlp(generator: torch.Generator, cfg: ArchConfig, device, stack: tuple = (),
             d_ff: int | None = None) -> dict:
    """MLP parameters (SwiGLU, or the gelu MLP's two matrices), each with
    the leading dims ``stack``; ``d_ff`` overrides the config's width
    (arctic's dense branch)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = getattr(torch, cfg.param_dtype)
    std = float(1.0 / np.sqrt(d))
    p = {}
    if cfg.mlp_kind == "swiglu":
        p["w_gate"] = _normal((*stack, d, f), generator, std, dt, device)
    p["w_up"] = _normal((*stack, d, f), generator, std, dt, device)
    p["w_down"] = _normal((*stack, f, d), generator, float(std / np.sqrt(cfg.n_layers)), dt,
                          device)
    return p


def ffn_hidden(p: dict, x: torch.Tensor) -> torch.Tensor:
    """An FFN's activation, the tensor the reference names ``ffn_h``: SwiGLU
    ``silu(x w_gate) * (x w_up)`` where the parameters hold ``w_gate``, else
    ``gelu(x w_up)``, rounded as the reference's compiled ones (`silu`,
    `gelu`); batched for the MoE's experts.  Its last op runs in a
    `checkpoint_name` region."""
    if "w_gate" in p:
        act, up = silu(matmul(x, _cast(p["w_gate"]))), matmul(x, _cast(p["w_up"]))
    else:
        up = matmul(x, _cast(p["w_up"]))
        act = _gelu_half(up)
    with checkpoint_name("ffn_h"):
        return act * up


def mlp(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU ``silu(x w_gate) * (x w_up) w_down`` where the parameters hold
    ``w_gate``, else ``gelu(x w_up) w_down`` (`ffn_hidden`)."""
    return matmul(ffn_hidden(p, x), _cast(p["w_down"]))
