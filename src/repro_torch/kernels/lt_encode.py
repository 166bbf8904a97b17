"""GF(2) LT encoding: the port's `lt_encode` kernel.

Replaces the Pallas TPU kernel `lt_encode_pallas`
(`repro/kernels/lt_encode.py`) and matches its oracle `lt_encode_ref`:

    out[r, :] = XOR_{t : valid[r, t]} payload[neighbors[r, t], :]

Payload and output are uint32 words carried as int32 bit patterns (XOR
does not care about sign; `as_int32_bits` / `as_uint32` convert numpy
uint32 arrays).  A neighbour index follows the reference gather's rule:
a negative index counts from the end once, then the index is clamped to
``[0, K)``.  Invalid slots are never read.  Any ``K, P, R, dmax >= 1`` is
accepted (the TPU kernel's (8, 512) tiling does not carry over).

`lt_encode` launches the CUDA kernel (``csrc/lt_encode.cu``) on CUDA
tensors and runs `lt_encode_plain` on CPU tensors; a CUDA tensor never
falls back to the plain version.  The kernel has two routes, which `plan`
chooses: "vector" (each thread gathers one 16-byte vector of four source
rows at a time, with L2 cache hints) when the rows are whole 16-byte
vectors (P % 4 == 0) and the payload starts on a 16-byte boundary, "word"
(one 32-bit word a thread) otherwise.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

__all__ = ["lt_encode", "lt_encode_plain", "plan", "as_int32_bits", "as_uint32"]

_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def as_int32_bits(words) -> torch.Tensor:
    """An int32 tensor with the bits of a uint32 numpy array (or a tensor
    already holding int32 bit patterns)."""
    if torch.is_tensor(words):
        if words.dtype != torch.int32:
            raise TypeError(f"payload tensors hold int32 bit patterns, got {words.dtype}")
        return words
    return torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32).view(np.int32))


def as_uint32(words: torch.Tensor) -> np.ndarray:
    """The uint32 numpy array whose bits an int32 tensor holds."""
    return words.detach().cpu().numpy().view(np.uint32)


def _normalised(neighbors: torch.Tensor, K: int) -> torch.Tensor:
    idx = neighbors.to(torch.int64)
    return torch.clamp(torch.where(idx < 0, idx + K, idx), 0, K - 1)


def lt_encode_plain(payload: torch.Tensor, neighbors: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one ``[R, P]`` row gather per neighbour
    column, XORed into an accumulator (never the ``[R, dmax, P]`` gather)."""
    K = payload.shape[0]
    idx = _normalised(neighbors, K)
    ok = valid.to(torch.bool)
    acc = torch.zeros((neighbors.shape[0], payload.shape[1]), dtype=payload.dtype,
                      device=payload.device)
    for t in range(neighbors.shape[1]):
        rows = payload.index_select(0, torch.where(ok[:, t], idx[:, t], 0))
        acc ^= torch.where(ok[:, t:t + 1], rows, 0)
    return acc


def _check(payload, neighbors, valid):
    if payload.dim() != 2 or neighbors.dim() != 2 or valid.shape != neighbors.shape:
        raise ValueError("lt_encode takes payload [K, P], neighbors [R, dmax], "
                         "valid [R, dmax]")
    if payload.dtype != torch.int32:
        raise TypeError(f"payload holds int32 bit patterns, got {payload.dtype}")
    if neighbors.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"neighbors must be int32 or int64, got {neighbors.dtype}")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"valid must be bool or uint8, got {valid.dtype}")
    if min(*payload.shape, *neighbors.shape) < 1:
        raise ValueError(f"empty operand: payload {tuple(payload.shape)}, "
                         f"neighbors {tuple(neighbors.shape)}")
    if payload.shape[0] > _I32_MAX:
        raise ValueError("at most 2**31 - 1 source symbols")


def plan(payload: torch.Tensor) -> str:
    """The kernel's route for a contiguous payload ``[K, P]`` (the output
    is a fresh allocation, so always aligned): "vector" when P % 4 == 0
    and the base is 16-byte aligned, which 16-byte loads need; else
    "word"."""
    aligned = payload.data_ptr() % 16 == 0
    return "vector" if payload.shape[1] % 4 == 0 and aligned else "word"


_ROUTES = {"word": 0, "vector": 1}


@functools.cache
def _launcher():
    """The kernel's C entry point, built and bound at the first CUDA call."""
    from repro_torch.kernels.build import load

    fn = load("lt_encode").lt_encode_launch
    fn.argtypes = ([ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def lt_encode(payload: torch.Tensor, neighbors: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Encoded symbols int32[R, P]; launches the CUDA kernel for CUDA tensors."""
    _check(payload, neighbors, valid)
    dev = payload.device
    if dev.type == "cpu":
        return lt_encode_plain(payload, neighbors, valid)
    if dev.type != "cuda" or neighbors.device != dev or valid.device != dev:
        raise ValueError("lt_encode: all tensors must be on one CUDA device or the CPU")
    fn = _launcher()
    pay = payload.contiguous()
    nb = neighbors
    if nb.dtype != torch.int32:  # clamping into int32 keeps each normalised row
        nb = nb.clamp(_I32_MIN, _I32_MAX).to(torch.int32)
    nb = nb.contiguous()
    ok = (valid.view(torch.uint8) if valid.dtype == torch.bool else valid).contiguous()
    (K, P), (R, dmax) = pay.shape, nb.shape
    out = torch.empty((R, P), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(pay.data_ptr(), nb.data_ptr(), ok.data_ptr(), out.data_ptr(),
             K, P, R, dmax, _ROUTES[plan(pay)], stream)
    if err != 0:
        raise RuntimeError(f"lt_encode launch failed with CUDA error {err}")
    lt_encode.launches += 1
    return out


lt_encode.launches = 0
