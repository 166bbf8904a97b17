"""State-space and recurrent blocks: the port of the JAX package's
`models/ssm.py`, Mamba (jamba) and xLSTM's mLSTM and sLSTM (xlstm-350m).

Three forms share each block's parameters and arithmetic: prefill (a full
sequence; returns the final recurrent state too), decode (one token) and
the training form (``mamba``, ``mlstm``, ``slstm``: a full sequence, the
output only).  Every op is out of place, so autograd differentiates them.
Serving runs under ``no_grad``.  The training forms scan time with
`chunked_scan`, the reference's time-axis gradient checkpointing: chunks
of ``min(64, S)`` steps, each under a non-reentrant checkpoint, so that
the backward keeps one carry a chunk and recomputes one chunk at a time,
where the prefill forms' backward would keep every step's state (the
mLSTM's matrix memory and outer product, ``[B, H, dh, dh]`` each).  The
chunks run the prefill's ops in its order, so a training form's output
and gradients are bit-equal to the prefill's on one device.

Scan form.  The reference scans Mamba with an ``associative_scan`` inside
each 64-step chunk, which has its own f32 order.  The port scans every
recurrence by a plain loop over time, in f32: ``h = da h + db`` a step for
Mamba (its ``da``, ``db`` formed a chunk at a time), the reference's own
step functions for mLSTM and sLSTM.  States agree with the reference's to
f32 rounding (the tests hold them to 2e-5).  Mamba's prefill and every
training form require S to tile by ``min(64, S)``, as the reference does.

bf16 numerics follow the reference's compiled program on the CPU (`silu`
rounds every op; the sLSTM pre-activation reads the bf16 sum of its input
and recurrent parts unrounded, as XLA fuses it); f32 parameters (``a_log``,
``d_skip``, ``dt_bias``, ``b_if``, ``bias``) are read in f32, and in the
dtype training casts them to: ``exp(a_log)`` is taken in ``a_log``'s own
dtype, bf16 after the train step's cast, as the reference's.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import COMPUTE_DTYPE, _normal, matmul, rms_norm, sigmoid, silu

__all__ = [
    "chunked_scan",
    "init_mamba", "mamba", "mamba_prefill", "mamba_decode", "mamba_init_state",
    "init_mlstm", "mlstm", "mlstm_prefill", "mlstm_decode", "mlstm_init_state",
    "init_slstm", "slstm", "slstm_prefill", "slstm_decode", "slstm_init_state",
    "softplus",
]

_CHUNK = 64  # the reference's sequence chunk: S must tile by min(_CHUNK, S)


def _cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


def _at_least(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``jnp.maximum(x, bound)``: a tie splits the gradient evenly, as
    ``jax.grad`` does (``torch.clamp`` would pass all of it to ``x``)."""
    return torch.maximum(x, torch.full((), bound, dtype=x.dtype, device=x.device))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): ``max(x, 0) + log1p(exp(-|x|))``,
    its gradient 0.5 at 0 as the reference's."""
    return _at_least(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _chunk(S: int) -> int:
    chunk = min(_CHUNK, S)
    if S % chunk:
        raise ValueError(f"S={S} must tile by {chunk}")
    return chunk


def chunked_scan(scan, carry: tuple, xs: tuple, chunk: int):
    """Time-axis gradient checkpointing, the reference's `chunked_scan`.

    ``scan(*carry, *xs_c) -> (*carry', ys_c)`` runs a recurrence over the
    steps of ``xs_c``, tensors ``[B, c, ...]`` with time on axis 1.  Here it
    runs over ``xs`` (``[B, S, ...]``) ``chunk`` steps at a time, each chunk
    under a non-reentrant `torch.utils.checkpoint`; returns ``(carry, ys)``,
    the chunks' ys joined on axis 1.  The backward keeps each chunk's
    incoming carry and recomputes one chunk at a time: ``S / chunk`` carries
    plus one chunk's saved steps, for one more forward of the recurrence.
    A chunk takes the whole sequences and slices its steps itself, so every
    view a step saves is made in the chunk.  S must tile by ``chunk``."""
    S = xs[0].shape[1]
    if S % chunk:
        raise ValueError(f"S={S} must tile by {chunk}")
    n = len(carry)

    def body(s0, *args):
        return scan(*args[:n], *(x[:, s0:s0 + chunk] for x in args[n:]))

    ys = []
    for s0 in range(0, S, chunk):
        # the recurrences draw no random numbers: no RNG state to replay
        *carry, y = checkpoint(body, s0, *carry, *xs, use_reentrant=False,
                               preserve_rng_state=False)
        ys.append(y)
    return tuple(carry), torch.cat(ys, dim=1)


def _dt_rank(cfg: ArchConfig) -> int:
    return cfg.ssm_dt_rank or int(np.ceil(cfg.d_model / 16))


# ===========================================================================
# Mamba
# ===========================================================================
def init_mamba(generator: torch.Generator, cfg: ArchConfig, device, stack: tuple = ()) -> dict:
    d, n, kc = cfg.d_model, cfg.ssm_d_state, cfg.ssm_conv
    inner = cfg.ssm_expand * d
    r = _dt_rank(cfg)
    dt = getattr(torch, cfg.param_dtype)
    std = float(1.0 / np.sqrt(d))
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device).log()
    return {
        "in_proj": _normal((*stack, d, 2 * inner), generator, std, dt, device),
        "conv_w": _normal((*stack, kc, inner), generator, float(1.0 / np.sqrt(kc)), dt, device),
        "conv_b": torch.zeros((*stack, inner), dtype=dt, device=device),
        "x_proj": _normal((*stack, inner, r + 2 * n), generator, float(1.0 / np.sqrt(inner)), dt,
                          device),
        "dt_proj": _normal((*stack, r, inner), generator, float(1.0 / np.sqrt(r)), dt, device),
        "dt_bias": torch.full((*stack, inner), 0.01, device=device).expm1_().log_().to(dt),
        "a_log": a.expand(*stack, inner, n).clone(),  # f32: selective dynamics
        "d_skip": torch.ones((*stack, inner), dtype=torch.float32, device=device),
        "out_proj": _normal((*stack, inner, d), generator, float(std / np.sqrt(cfg.n_layers)),
                            dt, device),
    }


def mamba_init_state(cfg: ArchConfig, batch: int, device, stack: tuple = ()) -> dict:
    inner = cfg.ssm_expand * cfg.d_model
    return {
        "h": torch.zeros((*stack, batch, inner, cfg.ssm_d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((*stack, batch, cfg.ssm_conv - 1, inner), dtype=COMPUTE_DTYPE,
                            device=device),
    }


def _mamba_gates(p: dict, cfg: ArchConfig, xc: torch.Tensor):
    """xc [..., I] conv-activated input -> (dt [..., I], B [..., N], C [..., N]), f32."""
    n, r = cfg.ssm_d_state, _dt_rank(cfg)
    proj = matmul(xc, _cast(p["x_proj"]))
    dt_r, b, c = proj.split([r, n, n], dim=-1)
    dt = softplus(matmul(dt_r, _cast(p["dt_proj"])).float() + p["dt_bias"].float())
    return dt, b.float(), c.float()


def _causal_conv(p: dict, x: torch.Tensor, carry: torch.Tensor | None):
    """Depthwise causal conv over the sequence in bf16, a tap at a time as
    the reference adds them.  x: [B, S, I]; carry: [B, kc-1, I]."""
    kc = p["conv_w"].shape[0]
    if carry is None:
        carry = x.new_zeros((x.shape[0], kc - 1, x.shape[2]))
    xp = torch.cat([carry, x], dim=1)
    w = _cast(p["conv_w"])
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for t in range(1, kc):
        out = out + xp[:, t:t + S] * w[t]
    new_carry = xp[:, xp.shape[1] - (kc - 1):] if kc > 1 else carry
    return out + _cast(p["conv_b"]), new_carry


def _mamba_mix(p: dict, cfg: ArchConfig, x: torch.Tensor, conv: torch.Tensor | None):
    """The projections around the scan: (z, xc bf16, xc f32, dt, B, C f32,
    a, conv carry).  ``xc`` f32 is silu's last product unrounded: in the
    reference's compiled prefill XLA drops the bf16 round trip between silu
    and the scan's f32 read (measured against the jitted reference; a
    rounded xc moves the states by 3e-3 of their size)."""
    xs, z = matmul(x, _cast(p["in_proj"])).chunk(2, dim=-1)
    conv_out, conv_carry = _causal_conv(p, xs, conv)
    sig = sigmoid(conv_out)
    xc = conv_out * sig
    dt, bmat, cmat = _mamba_gates(p, cfg, xc)
    a = -torch.exp(p["a_log"]).float()                                  # [I, N]
    return z, xc, conv_out.float() * sig.float(), dt, bmat, cmat, a, conv_carry


def _mamba_out(p: dict, y: torch.Tensor, xc: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = y + xc.float() * p["d_skip"].float()
    return matmul(y.to(COMPUTE_DTYPE) * silu(z), _cast(p["out_proj"]))


def _mamba_scan(a: torch.Tensor, h, dt, xdt, bmat, cmat):
    """Mamba's recurrence over one chunk's steps (``[B, c, ...]``): ``da``
    and ``db`` formed for the chunk, then ``h = da h + db`` a step in f32.
    Returns (h, y [B, c, I])."""
    da = torch.exp(dt[..., None] * a)                                   # [B, c, I, N]
    db = xdt[..., None] * bmat[:, :, None, :]
    hs = []
    for da_t, db_t in zip(da.unbind(1), db.unbind(1)):
        h = torch.addcmul(db_t, da_t, h)
        hs.append(h)
    return h, torch.einsum("bcin,bcn->bci", torch.stack(hs, dim=1), cmat)


def mamba_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor):
    """Full-sequence selective SSM.  x: [B, S, D] -> (y [B, S, D], state)."""
    B, S, _ = x.shape
    chunk = _chunk(S)
    z, xc, xc32, dt, bmat, cmat, a, conv_carry = _mamba_mix(p, cfg, x, None)
    xdt = dt * xc32
    h = torch.zeros((B, *a.shape), dtype=torch.float32, device=x.device)
    ys = []
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        h, y = _mamba_scan(a, h, dt[:, sl], xdt[:, sl], bmat[:, sl], cmat[:, sl])
        ys.append(y)
    y = _mamba_out(p, torch.cat(ys, dim=1), xc32, z)
    return y, {"h": h, "conv": conv_carry}


def mamba(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The training form: `mamba_prefill`'s output, its chunks checkpointed
    (`chunked_scan`).  x: [B, S, D] -> y [B, S, D]."""
    B, S, _ = x.shape
    z, xc, xc32, dt, bmat, cmat, a, _ = _mamba_mix(p, cfg, x, None)
    h = torch.zeros((B, *a.shape), dtype=torch.float32, device=x.device)
    _, y = chunked_scan(functools.partial(_mamba_scan, a), (h,), (dt, dt * xc32, bmat, cmat),
                        _chunk(S))
    return _mamba_out(p, y, xc32, z)


def mamba_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, state: dict):
    """One token.  x: [B, 1, D] -> (y [B, 1, D], state')."""
    z, xc, _, dt, bmat, cmat, a, conv_carry = _mamba_mix(p, cfg, x, state["conv"])
    da = torch.exp(dt[:, 0, :, None] * a)                               # [B, I, N]
    db = (dt[:, 0] * xc[:, 0].float())[..., None] * bmat[:, 0, None, :]
    h = da * state["h"] + db
    y = torch.einsum("bin,bn->bi", h, cmat[:, 0])[:, None]
    return _mamba_out(p, y, xc, z), {"h": h, "conv": conv_carry}


# ===========================================================================
# xLSTM: mLSTM
# ===========================================================================
def init_mlstm(generator: torch.Generator, cfg: ArchConfig, device, stack: tuple = ()) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    inner = int(cfg.xlstm_proj_factor * d)
    dh = inner // h
    dt = getattr(torch, cfg.param_dtype)
    std, si = float(1.0 / np.sqrt(d)), float(1 / np.sqrt(inner))
    b_if = torch.cat([torch.zeros(h), torch.full((h,), 3.0)]).to(device)
    return {
        "up": _normal((*stack, d, 2 * inner), generator, std, dt, device),
        "wq": _normal((*stack, inner, h, dh), generator, si, dt, device),
        "wk": _normal((*stack, inner, h, dh), generator, si, dt, device),
        "wv": _normal((*stack, inner, h, dh), generator, si, dt, device),
        "w_if": _normal((*stack, inner, 2 * h), generator, si, dt, device),
        "b_if": b_if.expand(*stack, 2 * h).clone(),
        "norm": torch.ones((*stack, inner), dtype=dt, device=device),
        "down": _normal((*stack, inner, d), generator, float(std / np.sqrt(cfg.n_layers)), dt,
                        device),
    }


def mlstm_init_state(cfg: ArchConfig, batch: int, device, stack: tuple = ()) -> dict:
    h = cfg.n_heads
    dh = int(cfg.xlstm_proj_factor * cfg.d_model) // h
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((*stack, batch, h, dh, dh), **f32),
        "n": torch.zeros((*stack, batch, h, dh), **f32),
        "m": torch.full((*stack, batch, h), -1e30, **f32),
    }


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsi,ihk->bshk")`` in bf16, then f32."""
    i, h, k = w.shape
    return matmul(x, _cast(w).reshape(i, h * k)).unflatten(-1, (h, k)).float()


def _mlstm_qkvg(p: dict, x: torch.Tensor):
    """x [B, S, inner] -> q, k, v [B, S, H, dh] f32; log i / f gates [B, S, H]."""
    q, k, v = (_heads(x, p[n]) for n in ("wq", "wk", "wv"))
    gif = matmul(x, _cast(p["w_if"])).float() + p["b_if"].float()
    h = q.shape[2]
    log_i, log_f = gif[..., :h], -softplus(-gif[..., h:])
    return q, k / float(np.float32(np.sqrt(k.shape[-1]))), v, log_i, log_f


def _mlstm_step(C, n, m, q, k, v, li, lf):
    """One stabilised mLSTM step, the reference's `_mlstm_step`."""
    m_new = torch.maximum(lf + m, li)
    i_p = torch.exp(li - m_new)
    f_p = torch.exp(lf + m - m_new)
    C = f_p[..., None, None] * C + i_p[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = _at_least(torch.einsum("bhk,bhk->bh", q, n).abs(), 1.0)
    return C, n, m_new, num / den[..., None]


def _mlstm_out(p: dict, cfg: ArchConfig, h: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h.to(COMPUTE_DTYPE), p["norm"], cfg.norm_eps) * silu(z)
    return matmul(h, _cast(p["down"]))


def _mlstm_scan(C, n, m, q, k, v, li, lf):
    """The mLSTM recurrence over the steps of q, k, v ``[B, c, H, dh]`` and
    the log gates ``[B, c, H]``: (C, n, m, h [B, c, H, dh])."""
    hs = []
    for q_t, k_t, v_t, li_t, lf_t in zip(*(t.unbind(1) for t in (q, k, v, li, lf))):
        C, n, m, h_t = _mlstm_step(C, n, m, q_t, k_t, v_t, li_t, lf_t)
        hs.append(h_t)
    return C, n, m, torch.stack(hs, dim=1)


def _mlstm_in(p: dict, x: torch.Tensor):
    """x [B, S, D] -> (z, (q, k, v, log i, log f))."""
    xin, z = matmul(x, _cast(p["up"])).chunk(2, dim=-1)
    return z, _mlstm_qkvg(p, xin)


def _mlstm_run(p: dict, cfg: ArchConfig, x: torch.Tensor, state: dict):
    z, qkvg = _mlstm_in(p, x)
    C, n, m, h = _mlstm_scan(state["C"], state["n"], state["m"], *qkvg)
    return _mlstm_out(p, cfg, h.flatten(2), z), {"C": C, "n": n, "m": m}


def mlstm_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor):
    """Full-sequence mLSTM block.  x: [B, S, D] -> (y, state)."""
    return _mlstm_run(p, cfg, x, mlstm_init_state(cfg, x.shape[0], x.device))


def mlstm(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The training form: `mlstm_prefill`'s output, its chunks checkpointed
    (`chunked_scan`; S must tile by ``min(64, S)``).  x: [B, S, D] -> y."""
    z, qkvg = _mlstm_in(p, x)
    state = mlstm_init_state(cfg, x.shape[0], x.device)
    _, h = chunked_scan(_mlstm_scan, (state["C"], state["n"], state["m"]), qkvg,
                        _chunk(x.shape[1]))
    return _mlstm_out(p, cfg, h.flatten(2), z)


def mlstm_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, state: dict):
    """One token.  x: [B, 1, D] -> (y [B, 1, D], state')."""
    return _mlstm_run(p, cfg, x, state)


# ===========================================================================
# xLSTM: sLSTM
# ===========================================================================
def init_slstm(generator: torch.Generator, cfg: ArchConfig, device, stack: tuple = ()) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    dt = getattr(torch, cfg.param_dtype)
    std = float(1.0 / np.sqrt(d))
    f_ff = int(d * 4 / 3)
    bias = torch.cat([torch.zeros(2 * d), torch.full((d,), 3.0), torch.zeros(d)]).to(device)
    return {
        "w_x": _normal((*stack, d, 4 * d), generator, std, dt, device),
        "w_h": _normal((*stack, h, dh, 4 * dh), generator, float(1 / np.sqrt(dh)), dt, device),
        "bias": bias.expand(*stack, 4 * d).clone(),
        "norm": torch.ones((*stack, d), dtype=dt, device=device),
        "ffn_gate": _normal((*stack, d, f_ff), generator, std, dt, device),
        "ffn_down": _normal((*stack, f_ff, d), generator, float(std / np.sqrt(cfg.n_layers)),
                            dt, device),
    }


def slstm_init_state(cfg: ArchConfig, batch: int, device, stack: tuple = ()) -> dict:
    shape, d = (*stack, batch, cfg.d_model), dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **d), "n": torch.ones(shape, **d),
            "m": torch.zeros(shape, **d), "h": torch.zeros(shape, **d)}


def _slstm_step(p: dict, cfg: ArchConfig, c, n, m, h, xw_t):
    """xw_t: [B, 4D] bf16, the input's part of this step's pre-activation."""
    B, H = h.shape[0], cfg.n_heads
    hr = h.reshape(B, H, -1).to(COMPUTE_DTYPE).transpose(0, 1)          # [H, B, dh]
    rec = matmul(hr, _cast(p["w_h"])).transpose(0, 1).reshape(B, 4 * cfg.d_model)
    pre = xw_t.float() + rec.float() + p["bias"].float()
    z_r, i_r, f_r, o_r = pre.chunk(4, dim=-1)
    z = torch.tanh(z_r)
    o = torch.sigmoid(o_r)
    log_f = -softplus(-f_r)
    m_new = torch.maximum(log_f + m, i_r)
    i_p = torch.exp(i_r - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c = f_p * c + i_p * z
    n = f_p * n + i_p
    h = o * c / _at_least(n, 1.0)
    return c, n, m_new, h


def _slstm_scan(p: dict, cfg: ArchConfig, c, n, m, h, xw):
    """The sLSTM recurrence over the steps of xw ``[B, c, 4D]``:
    (c, n, m, h, hs [B, c, D])."""
    hs = []
    for xw_t in xw.unbind(1):
        c, n, m, h = _slstm_step(p, cfg, c, n, m, h, xw_t)
        hs.append(h)
    return c, n, m, h, torch.stack(hs, dim=1)


def _slstm_out(p: dict, cfg: ArchConfig, hs: torch.Tensor) -> torch.Tensor:
    hh = rms_norm(hs.to(COMPUTE_DTYPE), p["norm"], cfg.norm_eps)
    return matmul(silu(matmul(hh, _cast(p["ffn_gate"]))), _cast(p["ffn_down"]))


def _slstm_run(p: dict, cfg: ArchConfig, x: torch.Tensor, state: dict):
    xw = matmul(x, _cast(p["w_x"]))                                            # [B, S, 4D]
    c, n, m, h, hs = _slstm_scan(p, cfg, *(state[k] for k in ("c", "n", "m", "h")), xw)
    return _slstm_out(p, cfg, hs), {"c": c, "n": n, "m": m, "h": h}


def slstm_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor):
    """Full-sequence sLSTM block (sequential over S).  x: [B, S, D]."""
    return _slstm_run(p, cfg, x, slstm_init_state(cfg, x.shape[0], x.device))


def slstm(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The training form: `slstm_prefill`'s output, its chunks checkpointed
    (`chunked_scan`; S must tile by ``min(64, S)``).  x: [B, S, D] -> y."""
    xw = matmul(x, _cast(p["w_x"]))
    state = slstm_init_state(cfg, x.shape[0], x.device)
    _, hs = chunked_scan(functools.partial(_slstm_scan, p, cfg),
                         tuple(state[k] for k in ("c", "n", "m", "h")), (xw,), _chunk(x.shape[1]))
    return _slstm_out(p, cfg, hs)


def slstm_decode(p: dict, cfg: ArchConfig, x: torch.Tensor, state: dict):
    """One token.  x: [B, 1, D] -> (y [B, 1, D], state')."""
    return _slstm_run(p, cfg, x, state)
