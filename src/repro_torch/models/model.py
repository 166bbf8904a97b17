"""Top-level model API of the port, for all ten architectures.

  init_params / compute_params   - parameter tree, and its bf16 compute copy
  train_loss                     - next-token cross-entropy (+ MoE aux), differentiable
  make_cache                     - zeroed caches and states for serving
  prefill / decode_step          - serving paths; caches updated in place

The port of the JAX package's `models/model.py`: decoder-only LMs (dense,
MoE, hybrid, SSM, VLM) and the encoder-decoder (audio).  Modality
frontends are stubs, as there: the batch carries pre-computed patch or
frame embeddings, and a small learned projector maps them into the
backbone (llava's two-layer gelu MLP; whisper's frame projection, a
sinusoidal signal and a non-causal encoder).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import resolve_device
from repro_torch.models.layers import COMPUTE_DTYPE, gelu, matmul, rms_norm
from repro_torch.models.transformer import (
    init_stack,
    init_stack_cache,
    run_stack_decode,
    run_stack_prefill,
    run_stack_train,
)

__all__ = ["ENC_PERIOD", "init_params", "compute_params", "train_loss", "make_cache",
           "prefill", "decode_step"]

# whisper-style encoder period: non-causal self-attention + MLP
ENC_PERIOD = (LayerSpec("attn", "mlp"),)

# leaves the reference casts to bf16 where it uses it.  Read in f32: the
# norm scales, the embedding table and the head, and the f32 leaves of the
# MoE router and the recurrent blocks (router, a_log, d_skip, dt_bias,
# b_if, bias).
_BF16_LEAVES = frozenset({
    "wq", "wk", "wv", "wo", "bq", "bk", "bv",                 # attention
    "w_gate", "w_up", "w_down",                               # MLP, experts
    "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "out_proj",  # mamba
    "up", "w_if", "down",                                     # mLSTM
    "w_x", "w_h", "ffn_gate", "ffn_down",                     # sLSTM
    "frontend_proj", "w1", "w2",                              # frontends
})


def _normal(generator, shape, std, dt, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dt, device=device).mul_(std)


def init_params(generator: torch.Generator, cfg: ArchConfig) -> dict:
    """Parameter tree in ``cfg.param_dtype`` on the generator's device, drawn
    from ``generator`` (the layout of the reference's tree, not its
    numbers: jax.random's stream is not reproduced)."""
    device = generator.device
    dt = getattr(torch, cfg.param_dtype)
    d, v = cfg.d_model, cfg.vocab_size
    std = float(1.0 / np.sqrt(d))
    p: Dict[str, object] = {
        "embed": _normal(generator, (v, d), std, dt, device),
        "final_norm": torch.ones((d,), dtype=dt, device=device),
        "layers": init_stack(generator, cfg, device),
    }
    if not cfg.tie_embeddings:
        p["head"] = _normal(generator, (d, v), std, dt, device)
    if cfg.is_encdec:
        p["encoder"] = {
            "layers": init_stack(generator, cfg, device, period=ENC_PERIOD,
                                 n_layers=cfg.encoder_layers),
            "final_norm": torch.ones((d,), dtype=dt, device=device),
            "frontend_proj": _normal(generator, (d, d), std, dt, device),
        }
    if cfg.frontend == "vision_patches":
        # llava-style 2-layer MLP projector
        p["mm_proj"] = {"w1": _normal(generator, (d, d), std, dt, device),
                        "w2": _normal(generator, (d, d), std, dt, device)}
    return p


def compute_params(params: dict) -> dict:
    """The tree with a bf16 copy of every leaf the reference casts to bf16
    where it uses it (the cast gives the same bits each time; a bf16 leaf is
    shared, not copied); the other leaves are shared."""
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
    """Zeroed caches and states for ``batch`` sequences of up to ``seq_len``
    positions (a sliding window bounds the KV capacity).  An enc-dec model's
    cross-attention caches get ``seq_len`` slots, as the reference's;
    prefill replaces them by the encoder's K/V, of the frames' length."""
    enc_len = seq_len if cfg.is_encdec else 0
    return init_stack_cache(cfg, batch, seq_len, resolve_device(device), enc_len=enc_len)


def _embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' rows of the table, in bf16.  `F.embedding`, whose
    gradient sums a row's tokens in order on the CPU and the card (an
    indexing gradient, ``index_put_`` with accumulation, sums them in an
    order that may change from run to run on the CPU)."""
    return F.embedding(tokens, p["embed"]).to(COMPUTE_DTYPE)


def _unembed(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, then the head in f32 (as the reference: ``x.astype(f32)
    @ w.astype(f32)``)."""
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    w = p["head"] if "head" in p else p["embed"].T
    return x.float() @ w.float()


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """[..., S] -> f32 [..., S, d] (whisper-style fixed positional signal);
    the frequencies in float64 numpy, then f32, as the reference's."""
    half = d // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / max(half - 1, 1))
    ang = positions[..., None].float() * torch.as_tensor(freqs.astype(np.float32),
                                                         device=positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _positions(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])


def _encode(p: dict, cfg: ArchConfig, frames: torch.Tensor, *, plain: bool,
            remat: bool = False) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings [B, S_enc, D]: the
    stack of `ENC_PERIOD` run non-causal (RoPE applied, as the reference's)."""
    enc = p["encoder"]
    x = matmul(frames.to(COMPUTE_DTYPE), enc["frontend_proj"].to(COMPUTE_DTYPE))
    pos = _positions(frames)
    x = x + _sinusoidal(pos, cfg.d_model).to(COMPUTE_DTYPE)
    x, _ = run_stack_train(enc["layers"], cfg, x, pos, causal=False, remat=remat, plain=plain,
                           period=ENC_PERIOD)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _backbone_inputs(p: dict, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *, plain: bool,
                     remat: bool = False):
    """-> (x [B, S, D], positions [B, S], encoder output or None); a vision
    model's S counts its patch prefix."""
    x = _embed_tokens(p, batch["tokens"])
    enc_out = None
    if cfg.frontend == "vision_patches":
        w1, w2 = (p["mm_proj"][k].to(COMPUTE_DTYPE) for k in ("w1", "w2"))
        proj = matmul(gelu(matmul(batch["patches"].to(COMPUTE_DTYPE), w1)), w2)
        x = torch.cat([proj, x], dim=1)
    if cfg.is_encdec:
        enc_out = _encode(p, cfg, batch["frames"], plain=plain, remat=remat)
        # whisper decoder: fixed sinusoidal positions (RoPE too, as the reference)
        x = x + _sinusoidal(_positions(x), cfg.d_model).to(COMPUTE_DTYPE)
    return x, _positions(x), enc_out


def train_loss(p: dict, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
               aux_weight: float = 0.01, remat: bool = True, plain: bool = False,
               routes=None):
    """Next-token cross-entropy over the text positions, plus the MoE
    sublayers' load-balance loss: ``(loss, {"ce", "moe_aux"})``, f32
    scalars, differentiable in ``p``.  As the reference's `train_loss`: a
    vision model's patch prefix is not scored, the logits are f32 (the
    head in f32 over the weights it is given), and the aux term is
    ``aux_weight * aux`` over the MoE sublayer count.  ``remat``
    checkpoints each sublayer (`run_stack_train`); ``plain`` runs the
    attention kernels' plain versions; ``routes`` records or replays the
    MoE choices (`moe.Routes`)."""
    if routes is not None:
        routes.begin_pass()
    x, positions, enc_out = _backbone_inputs(p, cfg, batch, plain=plain, remat=remat)
    x, aux = run_stack_train(p["layers"], cfg, x, positions, encoder_out=enc_out, remat=remat,
                             plain=plain, routes=routes)
    logits = _unembed(p, cfg, x)                       # [B, S, V] f32
    tokens = batch["tokens"]
    T = tokens.shape[1]
    prefix = x.shape[1] - T                            # vlm patch prefix
    # next-token targets within the text region, every one of them scored
    lg = logits[:, prefix:prefix + T - 1]
    lse = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, tokens[:, 1:, None].long())[..., 0]
    ce = (lse - gold).sum() / max(lse.numel(), 1)
    n_moe = sum(1 for s in cfg.period if s.ffn == "moe")
    loss = ce + aux_weight * aux / max(n_moe * cfg.n_periods, 1) if n_moe else ce
    return loss, {"ce": ce, "moe_aux": aux}


def prefill(p: dict, cfg: ArchConfig, batch: Dict[str, torch.Tensor], cache: dict, *,
            plain: bool = False, routes=None):
    """Run the full prompt; returns (last-position logits f32[B, V], cache).
    ``batch`` holds ``tokens`` [B, S] and, by the config's frontend,
    ``patches`` [B, P, D] (a prefix of P positions) or ``frames``
    [B, S_enc, D].  ``plain=True`` runs the attention kernels' plain
    versions; ``routes`` records or replays the MoE choices
    (`moe.Routes`)."""
    x, positions, enc_out = _backbone_inputs(p, cfg, batch, plain=plain)
    x, cache = run_stack_prefill(p["layers"], cfg, x, positions, cache, encoder_out=enc_out,
                                 plain=plain, routes=routes)
    return _unembed(p, cfg, x[:, -1:])[:, 0], cache


def decode_step(p: dict, cfg: ArchConfig, tokens: torch.Tensor, pos: torch.Tensor,
                cache: dict, *, plain: bool = False, routes=None):
    """One token for every sequence: tokens [B, 1], pos int[B] (absolute).
    Returns (logits f32[B, V], cache)."""
    x = _embed_tokens(p, tokens)
    if cfg.is_encdec:
        x = x + _sinusoidal(pos[:, None], cfg.d_model).to(COMPUTE_DTYPE)
    x, cache = run_stack_decode(p["layers"], cfg, x, pos, cache, plain=plain, routes=routes)
    return _unembed(p, cfg, x)[:, 0], cache
