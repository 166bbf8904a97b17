"""Causal / sliding-window GQA attention: the port's `flash_attention` kernel.

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

A CUDA tensor never falls back to the plain version.  The output has q's
layout.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import tma

__all__ = ["flash_attention", "flash_attention_plain", "plan", "Plan", "ROUTES"]

# the kernel each dtype takes on the card, and the source it is built from
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "cuda-core"}
_SOURCES = {"wgmma": "flash_attention", "cuda-core": "flash_attention_f32"}
MAX_HEAD_DIM = 256


def _scale(scale, D: int) -> float:
    return float(1.0 / math.sqrt(D)) if scale is None else float(scale)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int | None = None,
                          scale: float | None = None, q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version, the quadratic form of `flash_attention_ref`:
    f32 logits ``[B, H, Sq, Sk]``, masked to -inf, softmax, fully masked
    rows set to zero."""
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    group = H // KVH
    qf = q.float() * _scale(scale, D)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill_(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    del logits
    probs = probs.nan_to_num_(0.0)  # fully masked rows
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)


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
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None, q_offset: int = 0) -> torch.Tensor:
    """Attention output like q; launches a CUDA kernel for CUDA tensors."""
    _check(q, k, v, window)
    dev = q.device
    if dev.type == "cpu" and k.device == dev and v.device == dev:
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale,
                                     q_offset=q_offset)
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention: all tensors must be on one CUDA device or the CPU")
    how = plan(q, k, v)
    fn = _launcher(how.route)
    q, k, v = (_aligned_copy(t, how.route) if c else t for t, c in zip((q, k, v), how.copy))
    flash_attention.copies += sum(how.copy)
    # like the q the kernel reads, whose head-dim stride is 1: both kernels
    # write o with a unit head-dim stride
    o = torch.empty_like(q)
    B, H, Sq, D = q.shape
    KVH, Sk = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, o) for i in range(3)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, KVH, Sq, Sk, D,
             strides, _scale(scale, D), int(causal), 0 if window is None else int(window),
             int(q_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({how.route}) launch failed with error {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
flash_attention.copies = 0
