"""Single-token GQA decode over a KV cache: the port's `flash_decode` kernel.

Replaces the Pallas TPU kernel `flash_decode_pallas`
(`repro/kernels/flash_decode.py`).  One query token per sequence, q
``[B, H, D]``, attends over the cache k, v ``[B, Sk, KVH, D]`` (query head
h reads kv head ``h // (H // KVH)``), masked to the valid prefix
``kv_len[b]``.  The kernel returns the TPU kernel's un-normalised f32
partials ``(o, m, l)``: ``m`` the max scaled logit (-1e30 for a row that
sees no slot), ``l`` the sum of ``exp(s - m)``, ``o`` the matching sum of
values.  `flash_decode` returns the output that the JAX package's
`ops.flash_decode` returns, ``o / where(l > 0, l, 1)`` cast to q's type
(`normalise`), or the partials with ``return_lse=True``; `lse_combine`
merges partials of cache shards.

`flash_decode` runs `flash_decode_plain` on CPU tensors.  On CUDA tensors
it launches the Hopper kernel (``csrc/flash_decode.cu``) once, and nothing
else: the kernel reads kv_len as int32 or int64 and clamps it to
``[0, Sk]``, reads q through its strides, merges the cache ranges of its
persistent blocks (`decode_splits`) and normalises the output itself.  A
CUDA tensor never falls back to the plain version.  Any Sk and kv_len are
taken (the TPU kernel needs Sk to be a multiple of its tile), groups up to
16 and ``D <= 256``, f32 and bf16.

The kernel reads k and v with TMA through tensor maps, which need a
16-byte-aligned base and strides that are multiples of 16 bytes (`plan`);
the model's per-layer slices of its stacked ``[n, B, L, KVH, D]`` caches
meet that.  A view that does not is first copied into a padded contiguous
buffer, and `flash_decode.copies` counts it.  The blocks that share a
(b, kv head) pair meet on a per-device buffer of arrival counters that the
wrapper zeroes once and the kernel leaves zeroed: calls on two CUDA streams
at once are not supported, and the first call on a device must not be
inside a CUDA-graph capture (it allocates the counters).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import tma

__all__ = ["flash_decode", "flash_decode_plain", "normalise", "lse_combine", "decode_splits",
           "plan", "Cut"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MASKED = -1e30
SLOTS_PER_TILE = 64  # the kernel's tile of cache slots
MAX_BLOCKS = 256  # the kernel's limit on its persistent blocks
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


@dataclasses.dataclass(frozen=True)
class Cut:
    """The kernel's cut of the cache: the ``pairs`` (b, kv head) pairs'
    tiles of 64 slots, laid end to end, cut into ``blocks`` ranges."""

    pairs: int
    tiles_per_pair: int
    blocks: int

    def ranges(self) -> list:
        """Each block's ``[start, end)`` in the flat tile range."""
        total = self.pairs * self.tiles_per_pair
        return [(i * total // self.blocks, (i + 1) * total // self.blocks)
                for i in range(self.blocks)]


def decode_splits(B: int, KVH: int, Sk: int, sms: int) -> Cut:
    """One persistent block per SM (fewer when there are fewer tiles), each
    streaming a range of whole tiles; the ranges' lengths differ by at most
    one.  The cut is made on Sk: kv_len lives on the device."""
    tiles = -(-Sk // SLOTS_PER_TILE)
    return Cut(B * KVH, tiles, max(1, min(sms, MAX_BLOCKS, B * KVH * tiles)))


def plan(k: torch.Tensor, v: torch.Tensor) -> tuple:
    """Whether the wrapper copies k and v first: TMA cannot read them."""
    return tuple(not tma.ready(t) for t in (k, v))


_COUNTERS: dict = {}


def _counters(dev: torch.device, pairs: int) -> torch.Tensor:
    """The device's zeroed arrival counters, at least ``pairs`` of them."""
    buf = _COUNTERS.get(dev.index)
    if buf is None or buf.numel() < pairs:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("flash_decode: call it once outside CUDA-graph capture first "
                               "(it allocates its counters)")
        buf = torch.zeros(max(pairs, 4096), dtype=torch.int32, device=dev)
        _COUNTERS[dev.index] = buf
    return buf


@functools.cache
def _launcher():
    """The kernel's C entry point, built and bound at the first CUDA call."""
    from repro_torch.kernels.build import load

    fn = load("flash_decode").flash_decode_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel(q, k, v, kv_len, scale, return_lse):
    fn = _launcher()
    dev = q.device
    copy = plan(k, v)
    k, v = (tma.aligned_copy(t) if c else t for t, c in zip((k, v), copy))
    flash_decode.copies += sum(copy)
    B, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    cut = decode_splits(B, KVH, Sk, _sm_count(dev.index))
    count = _counters(dev, cut.pairs)
    work = torch.empty((cut.pairs + cut.blocks) * (H // KVH) * (D + 2), dtype=torch.float32,
                       device=dev)
    if return_lse:
        res = (torch.empty((B, H, D), dtype=torch.float32, device=dev),
               torch.empty((B, H), dtype=torch.float32, device=dev),
               torch.empty((B, H), dtype=torch.float32, device=dev))
        ptrs = [t.data_ptr() for t in res] + [None]
    else:
        res = torch.empty((B, H, D), dtype=q.dtype, device=dev)
        ptrs = [None, None, None, res.data_ptr()]
    strides = (ctypes.c_longlong * 9)(*q.stride(), *(t.stride(i) for t in (k, v)
                                                     for i in (0, 2, 1)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    kv_len = kv_len.contiguous()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
             int(kv_len.dtype == torch.int64), *ptrs, work.data_ptr(), count.data_ptr(),
             _DTYPES[q.dtype], B, H, KVH, Sk, D, strides, scale, cut.blocks, stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed with error {err}")
    flash_decode.launches += 1
    return res


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: torch.Tensor, *,
                 scale: float | None = None, return_lse: bool = False):
    """Decode attention ``[B, H, D]`` in q's type, or the f32 partials
    ``(o, m, l)`` with ``return_lse=True``; one kernel launch for CUDA
    tensors."""
    _check(q, k, v, kv_len)
    dev = q.device
    D = q.shape[-1]
    scale = float(1.0 / math.sqrt(D)) if scale is None else float(scale)
    same = k.device == dev and v.device == dev and kv_len.device == dev
    if dev.type == "cpu" and same:
        o, m, l = flash_decode_plain(q, k, v, kv_len, scale=scale)
        return (o, m, l) if return_lse else normalise(o, l, q.dtype)
    if dev.type == "cuda" and same:
        return _kernel(q, k, v, kv_len, scale, return_lse)
    raise ValueError("flash_decode: all tensors must be on one CUDA device or the CPU")


flash_decode.launches = 0
flash_decode.copies = 0
