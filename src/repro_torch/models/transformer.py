"""Layer-stack assembly: the port of the JAX package's `models/transformer.py`
for every sublayer kind of the model zoo.

A model is ``embed -> periods -> final_norm -> unembed``.  One period is
the config's repeating sublayer pattern (jamba: 7 mamba + 1 attention,
MoE on odd sublayers; whisper's decoder: self-attention, then
cross-attention + MLP; xLSTM: mLSTM, sLSTM); period parameters are stacked
on a leading axis, and a Python loop over that axis takes the place of the
reference's ``lax.scan``.  Three modes share the parameters:

* train   - a full sequence without caches, differentiable, each sublayer
            checkpointed (recomputed in the backward) as the reference's
            ``jax.checkpoint`` per sublayer, and inside a recurrent
            sublayer each 64-step chunk of its scan (`ssm.chunked_scan`);
            ``remat_policy="save_ffn"`` keeps the FFN's named products;
            returns the MoE aux loss too (whisper's encoder runs it
            non-causal);
* prefill - the full prompt, filling every sublayer's cache or state;
* decode  - one token against the (ring-buffer) KV caches and states.

Sublayer kinds: ``attn`` (self), ``xattn`` (cross, enc-dec), ``mamba``,
``mlstm``, ``slstm``; FFNs ``mlp``, ``moe`` (with arctic's parallel dense
branch ``ffn_dense``) or ``none``.  Caches and states are updated in place,
but a cross-attention cache is replaced at prefill by the encoder's K/V,
whose length is the frames' (a cache made for another length is
reallocated).  With ``kv_quant`` the self-attention caches hold int8
entries and f32 scales.

The residual stream is bf16, but a norm reads the residual sum before it
in f32 when both lie in one period: the reference's compiled program (XLA
fuses the bf16 add into the norm's f32 input) keeps that sum unrounded,
and its scan carries the period's last sum rounded (measured bit for bit
on the CPU).  Training keeps the same rounding: the reference's forward
inlines each checkpointed sublayer, so its fusions are the prefill's
(measured against the jitted reference on the CPU: with every
sublayer's output rounded instead, whisper's loss moves 40x and jamba's 2x
further from it, and jamba's and xlstm's gradients twice as far).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    _project,
    attention,
    attention_decode,
    cross_attention_decode,
    init_attention,
    init_mlp,
    kv_quantize,
    mlp,
    rms_norm,
    save_only_these_names,
)

__all__ = [
    "init_stack",
    "run_stack_train",
    "run_stack_prefill",
    "run_stack_decode",
    "init_stack_cache",
    "cache_len_for",
]

_KINDS = ("attn", "xattn", "mamba", "mlstm", "slstm")
_FFNS = ("mlp", "moe", "none")


def _check_spec(spec: LayerSpec) -> None:
    if spec.kind not in _KINDS or spec.ffn not in _FFNS:
        raise ValueError(f"unknown sublayer {spec}")


def _periods(cfg: ArchConfig, period, n_layers) -> tuple:
    period = period or cfg.period
    for spec in period:
        _check_spec(spec)
    return period, (n_layers or cfg.n_layers) // len(period)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
_MIXER_INIT = {"attn": init_attention, "xattn": init_attention, "mamba": ssm.init_mamba,
               "mlstm": ssm.init_mlstm, "slstm": ssm.init_slstm}


def _init_sublayer(generator, cfg: ArchConfig, spec: LayerSpec, device, stack) -> dict:
    dt = getattr(torch, cfg.param_dtype)
    p = {"norm1": torch.ones((*stack, cfg.d_model), dtype=dt, device=device),
         "mixer": _MIXER_INIT[spec.kind](generator, cfg, device, stack)}
    if spec.ffn != "none":
        p["norm2"] = torch.ones((*stack, cfg.d_model), dtype=dt, device=device)
        if spec.ffn == "moe":
            p["ffn"] = moe_mod.init_moe(generator, cfg, device, stack)
            if cfg.moe_dense_ff:  # arctic: parallel dense residual branch
                p["ffn_dense"] = init_mlp(generator, cfg, device, stack, d_ff=cfg.moe_dense_ff)
        else:
            p["ffn"] = init_mlp(generator, cfg, device, stack)
    return p


def init_stack(generator: torch.Generator, cfg: ArchConfig, device, period=None,
               n_layers=None) -> dict:
    """Stacked period params: every leaf gets a leading dim of the period
    count (drawn stacked, so the full width never holds two copies).
    ``period`` / ``n_layers`` default to the config's (the encoder passes
    its own)."""
    period, n_p = _periods(cfg, period, n_layers)
    return {f"sub{i}": _init_sublayer(generator, cfg, s, device, (n_p,))
            for i, s in enumerate(period)}


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


def _sublayer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int, seq_len: int, enc_len: int,
                    device, stack) -> dict:
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    if spec.kind in ("attn", "xattn"):
        L = cache_len_for(cfg, seq_len) if spec.kind == "attn" else enc_len
        shape = (*stack, batch, L, kvh, dh)
        if spec.kind == "attn" and cfg.kv_quant:
            return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                    "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
        return {"k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
                "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}
    return getattr(ssm, f"{spec.kind}_init_state")(cfg, batch, device, stack)


def init_stack_cache(cfg: ArchConfig, batch: int, seq_len: int, device, enc_len: int = 0) -> dict:
    """Zeroed caches and states per sublayer, each with a leading dim of
    n_periods: KV caches ``[n, B, L, KVH, Dh]`` (bf16, or int8 with f32
    scales ``[n, B, L, KVH]``), cross-attention caches of ``enc_len`` slots,
    and the recurrent blocks' initial states."""
    period, n_p = _periods(cfg, None, None)
    return {f"sub{i}": _sublayer_cache(cfg, s, batch, seq_len, enc_len, device, (n_p,))
            for i, s in enumerate(period)}


# ---------------------------------------------------------------------------
# forward modes
# ---------------------------------------------------------------------------
def _ffn_apply(p: dict, cfg: ArchConfig, spec: LayerSpec, x_sum: torch.Tensor, *,
               last: bool, routes=None, site=None):
    """Post-mixer FFN with residual.  ``x_sum`` is the mixer's residual sum
    in f32: rounded to bf16 for the stream, unrounded for the norm.  Returns
    (the new residual sum, the MoE's aux loss or None): the sum in f32 for
    the next sublayer's norm, or rounded to bf16 for the period's ``last``
    sublayer (the reference's scan carries it in bf16).  ``site`` names a
    training call's MoE site (`moe.Routes`)."""
    x = x_sum.to(COMPUTE_DTYPE)
    if spec.ffn == "none":
        return (x if last else x_sum), None
    h = rms_norm(x_sum, p["norm2"], cfg.norm_eps).to(COMPUTE_DTYPE)
    aux = None
    if spec.ffn == "moe":
        y, aux = moe_mod.moe(p["ffn"], cfg, h, routes, site)
        if "ffn_dense" in p:
            y = y + mlp(p["ffn_dense"], cfg, h)
    else:
        y = mlp(p["ffn"], cfg, h)
    return (x + y if last else x.float() + y.float()), aux


def _encoder_kv(p: dict, enc_out: torch.Tensor):
    """Cross-attention's keys and values from the encoder output (no bias,
    no RoPE, as the reference projects them)."""
    return _project(enc_out, p["wk"]), _project(enc_out, p["wv"])


def _unstack(tree, n: int) -> list:
    """A stacked tree as ``n`` per-period trees (`torch.unbind`, whose
    backward stacks the periods' gradients once)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


def _mixer_train(p, cfg: ArchConfig, spec: LayerSpec, x, positions, enc_out, *, causal,
                 plain):
    """The mixer of a full sequence without caches; ``x`` is the residual
    stream, bf16 or a period's f32 sum.  Returns the residual sum in f32."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps).to(COMPUTE_DTYPE)
    if spec.kind == "attn":
        y, _, _ = attention(p["mixer"], cfg, h, positions, causal=causal, plain=plain)
    elif spec.kind == "xattn":
        y, _, _ = attention(p["mixer"], cfg, h, positions, rotary=False,
                            kv=_encoder_kv(p["mixer"], enc_out), plain=plain)
    else:  # the training forms: time chunks checkpointed (`ssm.chunked_scan`)
        y = getattr(ssm, spec.kind)(p["mixer"], cfg, h)
    return x.to(COMPUTE_DTYPE).float() + y.float()


# remat_policy -> the names (`layers.checkpoint_name`) a sublayer's checkpoint keeps
REMAT_POLICIES = {None: (), "save_ffn": ("ffn_h", "ffn_out")}


def _context_fn(remat_policy):
    names = REMAT_POLICIES[remat_policy]
    if not names:
        return noop_context_fn
    return functools.partial(create_selective_checkpoint_contexts, save_only_these_names(*names))


def run_stack_train(params: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                    encoder_out: torch.Tensor | None = None, causal: bool = True,
                    remat: bool = True, remat_policy=None, plain: bool = False, *,
                    period=None, routes=None) -> tuple[torch.Tensor, torch.Tensor]:
    """A full sequence through the stack, differentiable: (x bf16 [B, S,
    D], the MoE sublayers' aux losses summed, f32); the residual sum inside
    a period stays f32, as in `run_stack_prefill`.  With ``remat`` each
    sublayer runs under `torch.utils.checkpoint` (non-reentrant): its
    activations are recomputed in the backward, so the attention kernel's
    forward runs twice a step.  ``period`` defaults to the config's
    (whisper's encoder passes its own, with ``causal=False``); ``routes``
    records or replays the MoE choices.  ``remat_policy="save_ffn"`` keeps
    the tensors the reference names ``ffn_h`` (the FFN's activation, the
    MLP's and the experts') and ``ffn_out`` (the experts' down product)
    through each checkpointed sublayer's backward, which then skips the ops
    that made them, and recomputes everything else (a selective checkpoint,
    `layers.save_only_these_names`); losses and gradients are bit-equal to
    ``remat_policy=None``'s.  Without ``remat`` the policy has nothing to
    do, as in the reference."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy={remat_policy!r}: expected one of "
                         f"{', '.join(map(repr, REMAT_POLICIES))}")
    context_fn = _context_fn(remat_policy)
    period = period or cfg.period
    for spec in period:
        _check_spec(spec)
    n_p = params["sub0"]["norm1"].shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for n, p_n in enumerate(_unstack(params, n_p)):
        for i, spec in enumerate(period):
            def run(p, xx, spec=spec, last=i == len(period) - 1, site=(n, i)):
                s = _mixer_train(p, cfg, spec, xx, positions, encoder_out, causal=causal,
                                 plain=plain)
                out, a = _ffn_apply(p, cfg, spec, s, last=last, routes=routes, site=site)
                return out, (torch.zeros_like(aux) if a is None else a)

            if remat:
                x, a = checkpoint(run, p_n[f"sub{i}"], x, use_reentrant=False,
                                  context_fn=context_fn)
            else:
                x, a = run(p_n[f"sub{i}"], x)
            aux = aux + a
    return x, aux


def _write_kv(cfg: ArchConfig, cache: dict, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write a prompt's k, v ``[B, S, KVH, Dh]`` into the full cache buffer
    at their (ring) slots: ``0 .. take-1`` without a window, ``pos % L``
    with one; quantized where the cache is int8."""
    S_in, L = k.shape[1], cache["k"].shape[1]
    take = min(S_in, L)
    if cfg.window:
        idx = (torch.arange(take, device=k.device) + (S_in - take)) % L
        k, v = k[:, S_in - take:], v[:, S_in - take:]
    else:
        idx = torch.arange(take, device=k.device)
        k, v = k[:, :take], v[:, :take]
    if "k_scale" in cache:
        for name, t in (("k", k), ("v", v)):
            q, s = kv_quantize(t)
            cache[name][:, idx] = q
            cache[f"{name}_scale"][:, idx] = s
    else:
        cache["k"][:, idx] = k
        cache["v"][:, idx] = v


def _set_state(cache: dict, state: dict) -> None:
    for name, value in state.items():
        cache[name].copy_(value)


def _mixer_prefill(p, cfg: ArchConfig, spec: LayerSpec, x, positions, enc_out, cache, *,
                   plain):
    """Full-sequence forward that also fills this sublayer's cache or state.
    Returns the residual sum in f32."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps).to(COMPUTE_DTYPE)
    if spec.kind == "attn":
        y, k, v = attention(p["mixer"], cfg, h, positions, plain=plain)
        _write_kv(cfg, cache, k, v)
    elif spec.kind == "xattn":
        kx, vx = _encoder_kv(p["mixer"], enc_out)
        y, _, _ = attention(p["mixer"], cfg, h, positions, rotary=False, kv=(kx, vx),
                            plain=plain)
        cache["k"].copy_(kx)
        cache["v"].copy_(vx)
    else:
        y, state = getattr(ssm, f"{spec.kind}_prefill")(p["mixer"], cfg, h)
        _set_state(cache, state)
    return x.to(COMPUTE_DTYPE).float() + y.float()


def _fit_cross_caches(cfg: ArchConfig, cache: dict, enc_out) -> None:
    """Replace each cross-attention cache whose length is not the encoder
    output's by one that is (the reference's prefill returns the encoder's
    K/V in its place)."""
    for i, spec in enumerate(cfg.period):
        c = cache[f"sub{i}"]
        if spec.kind == "xattn" and c["k"].shape[2] != enc_out.shape[1]:
            shape = (*c["k"].shape[:2], enc_out.shape[1], *c["k"].shape[3:])
            for name in ("k", "v"):
                c[name] = torch.empty(shape, dtype=c[name].dtype, device=c[name].device)


def run_stack_prefill(params: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                      cache: dict, *, encoder_out: torch.Tensor | None = None,
                      plain: bool = False, routes=None) -> tuple[torch.Tensor, dict]:
    period, n_p = _periods(cfg, None, None)
    if encoder_out is not None:
        _fit_cross_caches(cfg, cache, encoder_out)
    for n in range(n_p):
        p_n, c_n = _index(params, n), _index(cache, n)
        for i, spec in enumerate(period):
            x = _mixer_prefill(p_n[f"sub{i}"], cfg, spec, x, positions, encoder_out,
                               c_n[f"sub{i}"], plain=plain)
            x, _ = _ffn_apply(p_n[f"sub{i}"], cfg, spec, x, last=i == len(period) - 1,
                              routes=routes)
    return x, cache


def _mixer_decode(p, cfg: ArchConfig, spec: LayerSpec, x, pos, cache, *, plain):
    """x: [B, 1, D]; pos: int[B], the absolute position of this token.
    Returns the residual sum in f32."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps).to(COMPUTE_DTYPE)
    if spec.kind == "attn":
        L = cache["k"].shape[1]
        write_idx = pos % L if cfg.window else torch.clamp(pos, max=L - 1)
        kv_len = torch.clamp(pos + 1, max=L)
        y = attention_decode(p["mixer"], cfg, h, pos, cache, kv_len, write_idx=write_idx,
                             plain=plain)
    elif spec.kind == "xattn":
        y = cross_attention_decode(p["mixer"], cfg, h, cache, plain=plain)
    else:
        y, state = getattr(ssm, f"{spec.kind}_decode")(p["mixer"], cfg, h, cache)
        _set_state(cache, state)
    return x.to(COMPUTE_DTYPE).float() + y.float()


def run_stack_decode(params: dict, cfg: ArchConfig, x: torch.Tensor, pos: torch.Tensor,
                     cache: dict, *, plain: bool = False, routes=None) -> tuple[torch.Tensor, dict]:
    period, n_p = _periods(cfg, None, None)
    for n in range(n_p):
        p_n, c_n = _index(params, n), _index(cache, n)
        for i, spec in enumerate(period):
            x = _mixer_decode(p_n[f"sub{i}"], cfg, spec, x, pos, c_n[f"sub{i}"], plain=plain)
            x, _ = _ffn_apply(p_n[f"sub{i}"], cfg, spec, x, last=i == len(period) - 1,
                              routes=routes)
    return x, cache
