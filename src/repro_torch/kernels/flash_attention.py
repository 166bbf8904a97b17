"""Causal / sliding-window GQA attention: the port's `flash_attention` kernel
and its gradient.

Replaces the Pallas TPU kernel `flash_attention_pallas`
(`repro/kernels/flash_attention.py`) and matches its oracle
`flash_attention_ref`: q ``[B, H, Sq, D]`` attends over k, v ``[B, KVH,
Sk, D]`` (query head h reads kv head ``h // (H // KVH)``), query row i
sits at absolute position ``i + q_offset``, key j is visible when
``j <= i + q_offset`` (causal) and ``j > i + q_offset - window`` (a
window), scores are ``(scale * q) . k`` in f32, and the output is cast
to q's type (f32 or bf16).  A row that sees no key comes out as zeros.
Any Sq, Sk and ``D <= 256`` are taken (the TPU kernel's tiling limits do
not carry over).

`flash_attention` runs `flash_attention_plain` on CPU tensors and, on CUDA
tensors, one of two kernels chosen by dtype (`plan`):

* bf16: the tensor-core kernel (``csrc/flash_attention.cu``: wgmma, TMA and
  a pipelined K/V ring).  TMA reads q, k and v through tensor maps, which
  need a 16-byte-aligned base and strides that are multiples of 16 bytes;
  the model's ``[B, S, H, D]`` projections, handed over as transposed
  views, meet that at every head dim that is a multiple of 8.  An operand
  that does not (D = 20, an odd view) is first copied into a zero-padded
  contiguous buffer, and `flash_attention.copies` counts it.
* f32: the CUDA-core kernel (``csrc/flash_attention_f32.cu``), whose f32
  products meet the f32 tolerance that TF32 tensor-core products would
  not.  It reads any strides with a unit head-dim stride.

The gradient.  When an input requires grad (and grad mode is on),
`flash_attention` goes through a `torch.autograd.Function`: its forward
asks the kernel for the rows' log-sum-exp as well (``lse [B, H, Sq]``, f32,
the natural log of the sum of ``exp(scale q . k)`` over visible keys; -inf
for a row that sees no key), and its backward is `flash_attention_bwd`, the
hand-written kernel ``csrc/flash_attention_bwd.cu``, which recomputes the
probabilities from the saved lse.  The JAX package has no gradient of its
Pallas kernel (``jax.grad`` through ``flash_attention_pallas`` raises); its
trainer differentiates the chunked path (`repro.kernels.ref`), and the
port's tests take their reference gradient from there.  A call without
grad (serving) takes the plain forward launch: no lse, no saved tensors.
On CPU tensors the Function runs `flash_attention_plain` and
`flash_attention_bwd_plain`.

A CUDA tensor never falls back to a plain version.  The output has q's
layout.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import tma

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_with_lse",
           "flash_attention_bwd", "flash_attention_bwd_plain", "plan", "Plan", "ROUTES"]

# the kernel each dtype takes on the card, and the source it is built from
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "cuda-core"}
_SOURCES = {"wgmma": "flash_attention", "cuda-core": "flash_attention_f32"}
MAX_HEAD_DIM = 256


def _scale(scale, D: int) -> float:
    return float(1.0 / math.sqrt(D)) if scale is None else float(scale)


def _visible(Sq: int, Sk: int, causal: bool, window, q_offset: int, device) -> torch.Tensor:
    """[Sq, Sk] mask of the keys each query row sees."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _plain(q, k, v, causal, window, scale, q_offset, with_lse: bool):
    """The quadratic form: (o like q, lse f32 [B, H, Sq] or None)."""
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    group = H // KVH
    qf = q.float() * _scale(scale, D)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    mask = _visible(Sq, Sk, causal, window, q_offset, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1) if with_lse else None
    probs = torch.softmax(logits, dim=-1)
    del logits
    probs = torch.nan_to_num(probs, 0.0)  # fully masked rows
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype), lse


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int | None = None,
                          scale: float | None = None, q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version, the quadratic form of `flash_attention_ref`:
    f32 logits ``[B, H, Sq, Sk]``, masked to -inf, softmax, fully masked
    rows set to zero.  Out of place throughout, so autograd differentiates
    it (``plain=True`` training)."""
    return _plain(q, k, v, causal, window, scale, q_offset, False)[0]


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, window: int | None = None,
                              scale: float | None = None, q_offset: int = 0):
    """Plain PyTorch version of the backward, written out by the formula in
    f32: ``P = exp(scale q k^T - lse)`` on visible keys (0 elsewhere),
    ``dV = P^T dO``, ``dS = P * (dO V^T - rowsum(dO * O))``, ``dQ = scale dS
    K``, ``dK = scale dS^T Q``; dK and dV summed over each kv head's group of
    query heads.  Returns (dq, dk, dv) in the inputs' dtypes."""
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    group = H // KVH
    sc = _scale(scale, D)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    mask = _visible(Sq, Sk, causal, window, q_offset, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qf * sc, kf)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    del s
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    del p
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * sc
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * sc

    def fold(t):  # [B, H, Sk, D] -> [B, KVH, Sk, D]
        return t.unflatten(1, (KVH, group)).sum(dim=2)

    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention takes q [B, H, Sq, D], k and v [B, KVH, Sk, D]")
    B, H, Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B or D")
    if H % k.shape[1]:
        raise ValueError(f"{H} query heads do not group over {k.shape[1]} kv heads")
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if min(B, H, Sq, k.shape[2], D) < 1 or D > MAX_HEAD_DIM:
        raise ValueError(f"empty operand or head dim above {MAX_HEAD_DIM}: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def _on_cpu(*ts) -> bool:
    """All on the CPU; raises unless all are on one CUDA device instead."""
    dev = ts[0].device
    if dev.type == "cpu" and all(t.device == dev for t in ts):
        return True
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("flash_attention: all tensors must be on one CUDA device or the CPU")
    return False


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a CUDA call runs: the kernel's route, and which of q, k, v the
    wrapper copies first."""

    route: str
    copy: tuple


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Plan:
    """The route by dtype and the operands to copy."""
    route = ROUTES[q.dtype]
    if route == "wgmma":
        return Plan(route, tuple(not tma.ready(t) for t in (q, k, v)))
    return Plan(route, tuple(t.stride(-1) != 1 for t in (q, k, v)))


def _aligned_copy(t: torch.Tensor, route: str) -> torch.Tensor:
    """A contiguous copy; on the wgmma route with D padded with zeros to a
    multiple of 8, so that every stride is a multiple of 16 bytes."""
    return tma.aligned_copy(t) if route == "wgmma" else t.contiguous()


@functools.cache
def _launcher(route: str):
    """The route's C entry point, built and bound at its first CUDA call."""
    from repro_torch.kernels.build import load

    name = _SOURCES[route]
    fn = getattr(load(name), f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _forward(q, k, v, causal, window, scale, q_offset, with_lse: bool):
    """(o, lse or None): the plain version on the CPU, else one kernel launch."""
    _check(q, k, v, window)
    if _on_cpu(q, k, v):
        return _plain(q, k, v, causal, window, scale, q_offset, with_lse)
    how = plan(q, k, v)
    fn = _launcher(how.route)
    q, k, v = (_aligned_copy(t, how.route) if c else t for t, c in zip((q, k, v), how.copy))
    flash_attention.copies += sum(how.copy)
    # like the q the kernel reads, whose head-dim stride is 1: both kernels
    # write o with a unit head-dim stride
    o = torch.empty_like(q)
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, o) for i in range(3)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             0 if lse is None else lse.data_ptr(), B, H, KVH, Sq, Sk, D, strides,
             _scale(scale, D), int(causal), 0 if window is None else int(window), int(q_offset),
             stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({how.route}) launch failed with error {err}")
    flash_attention.launches += 1
    return o, lse


class _FlashAttention(torch.autograd.Function):
    """`flash_attention` with a gradient: the forward saves q, k, v, o and
    the rows' lse; the backward is `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        o, lse = _forward(q, k, v, causal, window, scale, q_offset, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None, q_offset: int = 0) -> torch.Tensor:
    """Attention output like q; launches a CUDA kernel for CUDA tensors, and
    is differentiable (through `flash_attention_bwd`) when an input
    requires grad."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale, q_offset)
    return _forward(q, k, v, causal, window, scale, q_offset, False)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = True, window: int | None = None,
                             scale: float | None = None, q_offset: int = 0):
    """(o, lse f32 [B, H, Sq]) with no gradient: the forward the autograd
    Function runs (the plain version's lse on the CPU)."""
    return _forward(q, k, v, causal, window, scale, q_offset, True)


flash_attention.launches = 0
flash_attention.copies = 0


@functools.cache
def _bwd_launcher():
    from repro_torch.kernels.build import load

    fn = load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, scale: float | None = None,
                        q_offset: int = 0):
    """(dq, dk, dv) of `flash_attention` from its output o, the rows' lse
    and the output's gradient do; `flash_attention_bwd_plain` on CPU
    tensors, else one launch of ``csrc/flash_attention_bwd.cu`` (a tensor
    whose head-dim stride is not 1 is copied first, counted in
    `flash_attention_bwd.copies`).  Outputs have the layouts of q, k, v."""
    _check(q, k, v, window)
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, Sq):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} or lse {tuple(lse.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"o and do must be {q.dtype} and lse float32, got {o.dtype}, "
                        f"{do.dtype}, {lse.dtype}")
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
    if _on_cpu(q, k, v, o, lse, do):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    fn = _bwd_launcher()
    ts = [q, k, v, o, do]
    for i, t in enumerate(ts):
        if t.stride(-1) != 1:
            ts[i] = t.contiguous()
            flash_attention_bwd.copies += 1
    q, k, v, o, do = ts
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(t.stride(i) for t in (q, k, v, o, do, dq, dk, dv)
                                         for i in range(3)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
             lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
             int(q.dtype == torch.bfloat16), B, H, KVH, Sq, Sk, D, strides, _scale(scale, D),
             int(causal), 0 if window is None else int(window), int(q_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed with error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.copies = 0
