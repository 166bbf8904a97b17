"""Batched Whack-a-Mole path selection: the port's `spray_select` kernel.

Replaces the Pallas TPU kernel `spray_select_pallas`
(`repro/kernels/spray_select.py`), generalised over rows: counters
``[R, B]``, inclusive cumulative profiles ``c [R, n]`` (any n) and seeds
``[R, 2]`` give paths ``int32[R, B]``.  With R = 1 it is the TPU kernel's
function; COMBINED is covered too (the TPU kernel refuses it).

`spray_select` launches the CUDA kernel (``csrc/spray_select.cu``) on CUDA
tensors and runs `spray_select_plain` on CPU tensors.  A CUDA tensor never
falls back to the plain version: the launch succeeds or raises.  Counters
and seeds are uint32 values held in int64 (the port's convention) or int32
bit patterns.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.spray import select_path, spray_key
from repro_torch.random import M32

__all__ = ["spray_select", "spray_select_plain"]


def spray_select_plain(counters: torch.Tensor, c: torch.Tensor,
                       seeds: torch.Tensor, *, ell: int, method: int) -> torch.Tensor:
    """Plain PyTorch version: spray key, then #{i : c(i) <= key} per row."""
    counters = counters.to(torch.int64) & M32
    seeds = seeds.to(torch.int64) & M32
    keys = spray_key(counters, seeds[:, 0:1], seeds[:, 1:2], ell, method)
    return select_path(c, keys)


def _as_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor with the same low 32 bits (the kernel reads uint32)."""
    if x.dtype == torch.int32:
        return x.contiguous()
    x = x.to(torch.int64) & M32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32).contiguous()


def _check(counters, c, seeds, ell, method):
    if counters.dim() != 2 or c.dim() != 2 or seeds.dim() != 2:
        raise ValueError("spray_select takes counters [R, B], c [R, n], seeds [R, 2]")
    R, B = counters.shape
    if c.shape[0] != R or seeds.shape != (R, 2):
        raise ValueError(f"row mismatch: counters {tuple(counters.shape)}, "
                         f"c {tuple(c.shape)}, seeds {tuple(seeds.shape)}")
    if B < 1 or R < 1:
        raise ValueError("empty counter batch")
    if c.shape[1] < 1:
        raise ValueError("no paths")
    if not 1 <= ell <= 31:
        raise ValueError(f"ell must be in [1, 31], got {ell}")
    if method not in (0, 1, 2, 3):
        raise ValueError(f"unknown spray method {method}")


@functools.cache
def _launcher():
    """The kernel's C entry point, built and bound at the first CUDA call."""
    from repro_torch.kernels.build import load

    fn = load("spray_select").spray_select_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def spray_select(counters: torch.Tensor, c: torch.Tensor, seeds: torch.Tensor,
                 *, ell: int, method: int) -> torch.Tensor:
    """Paths int32[R, B]; launches the CUDA kernel for CUDA tensors."""
    _check(counters, c, seeds, ell, method)
    dev = counters.device
    if dev.type == "cpu":
        return spray_select_plain(counters, c, seeds, ell=ell, method=int(method))
    if dev.type != "cuda" or c.device != dev or seeds.device != dev:
        raise ValueError("spray_select: all tensors must be on one CUDA device or the CPU")
    fn = _launcher()
    cnt = _as_u32_bits(counters)
    c32 = c.to(torch.int32).contiguous()
    s32 = _as_u32_bits(seeds)
    R, B = cnt.shape
    out = torch.empty((R, B), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(cnt.data_ptr(), c32.data_ptr(), s32.data_ptr(), out.data_ptr(),
             R, B, int(c32.shape[1]), int(ell), int(method), stream)
    if err != 0:
        raise RuntimeError(f"spray_select launch failed with CUDA error {err}")
    spray_select.launches += 1
    return out


spray_select.launches = 0
