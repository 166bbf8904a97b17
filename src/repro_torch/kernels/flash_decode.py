"""Single-token GQA decode over a KV cache: the port's `flash_decode` kernel.

Replaces the Pallas TPU kernel `flash_decode_pallas`
(`repro/kernels/flash_decode.py`).  One query token per sequence, q
``[B, H, D]``, attends over the cache k, v ``[B, Sk, KVH, D]`` (query head
h reads kv head ``h // (H // KVH)``), masked to the valid prefix
``kv_len[b]``.  The kernel returns the TPU kernel's un-normalised f32
partials ``(o, m, l)``: ``m`` the max scaled logit (-1e30 for a row that
sees no slot), ``l`` the sum of ``exp(s - m)``, ``o`` the matching sum of
values.  `flash_decode` normalises them as the JAX package's
`ops.flash_decode` does, ``o / where(l > 0, l, 1)`` cast to q's type, or
returns them with ``return_lse=True``; `lse_combine` merges partials of
cache shards.

`flash_decode` launches the CUDA kernel (``csrc/flash_decode.cu``) on CUDA
tensors and runs `flash_decode_plain` on CPU tensors; a CUDA tensor never
falls back to the plain version.  Any Sk and kv_len are taken (the TPU
kernel needs Sk to be a multiple of its tile), groups up to 16 and
``D <= 256``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

__all__ = ["flash_decode", "flash_decode_plain", "normalise", "lse_combine", "decode_splits"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MASKED = -1e30
_SLOTS_PER_TILE = 64  # the kernel's tile of cache slots
MAX_GROUP, MAX_HEAD_DIM = 16, 256


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_len: torch.Tensor, *, scale: float | None = None):
    """Plain PyTorch version of the TPU kernel's partials, one block over
    the whole cache: grouped-query einsums in f32, masked slots at -1e30."""
    B, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    group = H // KVH
    scale = float(1.0 / math.sqrt(D)) if scale is None else float(scale)
    qf = q.float().reshape(B, KVH, group, D) * scale
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k.float())
    mask = (torch.arange(Sk, device=q.device)[None, :]
            < kv_len.to(device=q.device, dtype=torch.int64)[:, None])[:, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, _MASKED))
    m = logits.amax(dim=-1)
    p = torch.where(mask, torch.exp(logits - m[..., None]), torch.zeros_like(logits))
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)


def normalise(o: torch.Tensor, l: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The attention output from the partials, as `ops.flash_decode`:
    ``o / where(l > 0, l, 1)`` cast to ``dtype``."""
    return (o / torch.where(l > 0, l, 1.0)[..., None]).to(dtype)


def lse_combine(partials) -> torch.Tensor:
    """Merge per-shard ``(o [B, H, D], m [B, H], l [B, H])`` partials into
    the normalised attention output over all shards (`ref.lse_combine`)."""
    o_acc, m_acc, l_acc = partials[0]
    for o, m, l in partials[1:]:
        m_new = torch.maximum(m_acc, m)
        a = torch.where(torch.isfinite(m_acc), torch.exp(m_acc - m_new), 0.0)
        b = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        o_acc = o_acc * a[..., None] + o * b[..., None]
        l_acc = l_acc * a + l * b
        m_acc = torch.where(torch.isfinite(m_new), m_new, m_acc)
    denom = torch.where(l_acc > 0, l_acc, 1.0)
    return o_acc / denom[..., None]


def _check(q, k, v, kv_len):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_decode takes q [B, H, D], k and v [B, Sk, KVH, D]")
    B, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or kv_len.shape != (B,):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and kv_len "
                         f"{tuple(kv_len.shape)} disagree")
    KVH = k.shape[2]
    if H % KVH or H // KVH > MAX_GROUP:
        raise ValueError(f"{H} query heads over {KVH} kv heads: groups of 1 to {MAX_GROUP}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if kv_len.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"kv_len must be int32 or int64, got {kv_len.dtype}")
    if min(B, H, k.shape[1], D) < 1 or D > MAX_HEAD_DIM:
        raise ValueError(f"empty operand or head dim above {MAX_HEAD_DIM}: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_splits(B: int, KVH: int, Sk: int, sms: int) -> tuple[int, int]:
    """``(nsplit, split_len)``: cut the cache's Sk slots into ranges of a
    whole number of 64-slot tiles, enough that the ``nsplit * B * KVH``
    blocks cover the card's SMs twice."""
    tiles = -(-Sk // _SLOTS_PER_TILE)
    want = max(1, min(tiles, -(-2 * sms // (B * KVH))))
    split_len = -(-tiles // want) * _SLOTS_PER_TILE
    return -(-Sk // split_len), split_len


@functools.cache
def _launcher():
    """The kernel's C entry point, built and bound at the first CUDA call."""
    from repro_torch.kernels.build import load

    fn = load("flash_decode").flash_decode_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel(q, k, v, kv_len, scale):
    fn = _launcher()
    dev = q.device
    q = q.contiguous()
    k = k if k.stride(-1) == 1 else k.contiguous()
    v = v if v.stride(-1) == 1 else v.contiguous()
    lens = kv_len.clamp(-2**31, 2**31 - 1).to(torch.int32).contiguous()
    B, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    nsplit, split_len = decode_splits(B, KVH, Sk, _sm_count(dev.index or 0))
    o = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, H), dtype=torch.float32, device=dev)
    work = (torch.empty(nsplit * B * H * (D + 2), dtype=torch.float32, device=dev)
            if nsplit > 1 else None)
    strides = (ctypes.c_longlong * 6)(*(t.stride(i) for t in (k, v) for i in range(3)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), o.data_ptr(),
             m.data_ptr(), l.data_ptr(), 0 if work is None else work.data_ptr(),
             _DTYPES[q.dtype], B, H, KVH, Sk, D, strides, scale, nsplit, split_len, stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed with CUDA error {err}")
    flash_decode.launches += 1
    return o, m, l


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: torch.Tensor, *,
                 scale: float | None = None, return_lse: bool = False):
    """Decode attention ``[B, H, D]`` in q's type, or the f32 partials
    ``(o, m, l)`` with ``return_lse=True``; launches the CUDA kernel for
    CUDA tensors."""
    _check(q, k, v, kv_len)
    dev = q.device
    D = q.shape[-1]
    scale = float(1.0 / math.sqrt(D)) if scale is None else float(scale)
    same = k.device == dev and v.device == dev and kv_len.device == dev
    if dev.type == "cpu" and same:
        o, m, l = flash_decode_plain(q, k, v, kv_len, scale=scale)
    elif dev.type == "cuda" and same:
        o, m, l = _kernel(q, k, v, kv_len, scale)
    else:
        raise ValueError("flash_decode: all tensors must be on one CUDA device or the CPU")
    if return_lse:
        return o, m, l
    return normalise(o, l, q.dtype)


flash_decode.launches = 0
