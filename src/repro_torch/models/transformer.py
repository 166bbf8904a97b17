"""Layer-stack assembly: the port of the JAX package's `models/transformer.py`
for the dense decoder stacks (attention + MLP sublayers).

A model is ``embed -> periods -> final_norm -> unembed``.  One period is
the config's repeating sublayer pattern; period parameters are stacked on
a leading axis, and a Python loop over that axis takes the place of the
reference's ``lax.scan``.  Two serving modes share the parameters:

* prefill - the full prompt, filling every sublayer's KV cache;
* decode  - one token against the (ring-buffer) KV caches.

Caches are updated in place.  The residual stream is bf16, but the FFN's
norm reads the attention residual's sum in f32: the reference's compiled
program (XLA fuses the bf16 add into the norm's f32 input) keeps that sum
unrounded, measured bit for bit on the CPU.  The sublayer kinds ``xattn``, ``mamba``,
``mlstm`` and ``slstm`` and MoE FFNs are not ported yet and raise
`NotImplementedError`.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    _check_mlp,
    attention,
    attention_decode,
    init_attention,
    init_mlp,
    mlp,
    rms_norm,
)

__all__ = [
    "init_stack",
    "run_stack_prefill",
    "run_stack_decode",
    "init_stack_cache",
    "cache_len_for",
    "check_stack",
]


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item 11: the rest of the model zoo)")


def _check_spec(spec: LayerSpec) -> None:
    if spec.kind != "attn":
        raise _unported(f"sublayer kind {spec.kind!r}")
    if spec.ffn not in ("mlp", "none"):
        raise _unported(f"ffn {spec.ffn!r}")


def check_stack(cfg: ArchConfig) -> None:
    """Raise for the first sublayer kind or FFN of ``cfg`` that is not
    ported, before anything is allocated."""
    for spec in cfg.period:
        _check_spec(spec)
        if spec.ffn == "mlp":
            _check_mlp(cfg)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_sublayer(generator, cfg: ArchConfig, spec: LayerSpec, device, stack) -> dict:
    _check_spec(spec)
    dt = getattr(torch, cfg.param_dtype)
    p = {"norm1": torch.ones((*stack, cfg.d_model), dtype=dt, device=device),
         "mixer": init_attention(generator, cfg, device, stack)}
    if spec.ffn != "none":
        p["norm2"] = torch.ones((*stack, cfg.d_model), dtype=dt, device=device)
        p["ffn"] = init_mlp(generator, cfg, device, stack)
    return p


def init_stack(generator: torch.Generator, cfg: ArchConfig, device) -> dict:
    """Stacked period params: every leaf gets a leading dim of n_periods
    (drawn stacked, so the full width never holds two copies)."""
    return {f"sub{i}": _init_sublayer(generator, cfg, s, device, (cfg.n_periods,))
            for i, s in enumerate(cfg.period)}


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def cache_len_for(cfg: ArchConfig, seq_len: int) -> int:
    """KV capacity for attention sublayers: the sliding window bounds it."""
    return min(cfg.window, seq_len) if cfg.window else seq_len


def init_stack_cache(cfg: ArchConfig, batch: int, seq_len: int, device) -> dict:
    """Zeroed bf16 KV caches ``[n_periods, B, L, KVH, Dh]`` per sublayer."""
    L = cache_len_for(cfg, seq_len)
    shape = (cfg.n_periods, batch, L, cfg.n_kv_heads, cfg.head_dim)
    cache = {}
    for i, spec in enumerate(cfg.period):
        _check_spec(spec)
        if cfg.kv_quant:
            raise _unported("the int8 KV cache (kv_quant)")
        cache[f"sub{i}"] = {"k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
                            "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}
    return cache


# ---------------------------------------------------------------------------
# forward modes
# ---------------------------------------------------------------------------
def _ffn_apply(p: dict, cfg: ArchConfig, spec: LayerSpec, x_sum: torch.Tensor) -> torch.Tensor:
    """Post-mixer FFN with residual.  ``x_sum`` is the mixer's residual sum
    in f32: rounded to bf16 for the stream, unrounded for the norm."""
    x = x_sum.to(COMPUTE_DTYPE)
    if spec.ffn == "none":
        return x
    h = rms_norm(x_sum, p["norm2"], cfg.norm_eps).to(COMPUTE_DTYPE)
    return x + mlp(p["ffn"], cfg, h)


def _mixer_prefill(p, cfg: ArchConfig, spec: LayerSpec, x, positions, cache, *, plain):
    """Full-sequence attention that also writes this sublayer's KV cache:
    slots ``0 .. take-1`` without a window, slot ``pos % L`` with one.
    Returns the residual sum in f32."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    y, k, v = attention(p["mixer"], cfg, h, positions, plain=plain)
    S_in, L = k.shape[1], cache["k"].shape[1]
    take = min(S_in, L)
    if cfg.window:
        idx = (torch.arange(take, device=x.device) + (S_in - take)) % L
        cache["k"][:, idx] = k[:, S_in - take:]
        cache["v"][:, idx] = v[:, S_in - take:]
    else:
        cache["k"][:, :take] = k[:, :take]
        cache["v"][:, :take] = v[:, :take]
    return x.float() + y.float()


def run_stack_prefill(params: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                      cache: dict, *, plain: bool = False) -> tuple[torch.Tensor, dict]:
    for spec in cfg.period:
        _check_spec(spec)
    for n in range(cfg.n_periods):
        p_n, c_n = _index(params, n), _index(cache, n)
        for i, spec in enumerate(cfg.period):
            x = _mixer_prefill(p_n[f"sub{i}"], cfg, spec, x, positions, c_n[f"sub{i}"],
                               plain=plain)
            x = _ffn_apply(p_n[f"sub{i}"], cfg, spec, x)
    return x, cache


def _mixer_decode(p, cfg: ArchConfig, spec: LayerSpec, x, pos, cache, *, plain):
    """x: [B, 1, D]; pos: int[B], the absolute position of this token.
    Returns the residual sum in f32."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    L = cache["k"].shape[1]
    write_idx = pos % L if cfg.window else torch.clamp(pos, max=L - 1)
    kv_len = torch.clamp(pos + 1, max=L)
    y = attention_decode(p["mixer"], cfg, h, pos, cache, kv_len, write_idx=write_idx,
                         plain=plain)
    return x.float() + y.float()


def run_stack_decode(params: dict, cfg: ArchConfig, x: torch.Tensor, pos: torch.Tensor,
                     cache: dict, *, plain: bool = False) -> tuple[torch.Tensor, dict]:
    for spec in cfg.period:
        _check_spec(spec)
    for n in range(cfg.n_periods):
        p_n, c_n = _index(params, n), _index(cache, n)
        for i, spec in enumerate(cfg.period):
            x = _mixer_decode(p_n[f"sub{i}"], cfg, spec, x, pos, c_n[f"sub{i}"], plain=plain)
            x = _ffn_apply(p_n[f"sub{i}"], cfg, spec, x)
    return x, cache
