"""Batched Whack-a-Mole path selection: the port's `spray_select` kernel.

Replaces the Pallas TPU kernel `spray_select_pallas`
(`repro/kernels/spray_select.py`), generalised over rows.  Two entries
call the one CUDA kernel (``csrc/spray_select.cu``):

* `spray_select(counters, c, seeds)`: the TPU kernel's function, with
  counters ``[R, B]``, inclusive cumulative profiles ``c [R, n]`` (any n)
  and seeds ``[R, 2]``; R = 1 is the TPU kernel's call.  COMBINED is
  covered too (the TPU kernel refuses it).
* `spray_select_rows(j, c, sa, sb, count)`: the row-base form the sender's
  WAM branch and `spray_paths` use, with counter ``(j[r] + i) mod 2**32``
  for lane ``i < count`` formed in the kernel, and ``j``, ``sa``, ``sb``
  each ``[R]`` or a 0-d scalar.

Both give paths ``int32[R, B]``.  Counters and seeds are uint32 values
held in int64 (the port's convention) or int32 bit patterns; the kernel
reads either dtype and any strides as they are, so a call on int32 or
int64 tensors with an int32 ``c`` whose rows have a unit stride is one
device operation.  CPU tensors run the plain versions; a CUDA tensor never
falls back to them: the launch succeeds or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.spray import select_path, spray_key
from repro_torch.kernels import count_launch
from repro_torch.random import M32

__all__ = ["spray_select", "spray_select_plain", "spray_select_rows",
           "spray_select_rows_plain"]

_MAX_DECISIONS = 2 ** 31 - 1  # the kernel indexes decisions in 32 bits


def spray_select_plain(counters: torch.Tensor, c: torch.Tensor,
                       seeds: torch.Tensor, *, ell: int, method: int) -> torch.Tensor:
    """Plain PyTorch version: spray key, then #{i : c(i) <= key} per row."""
    counters = counters.to(torch.int64) & M32
    seeds = seeds.to(torch.int64) & M32
    keys = spray_key(counters, seeds[:, 0:1], seeds[:, 1:2], ell, method)
    return select_path(c, keys)


def _per_row(x: torch.Tensor, R: int) -> torch.Tensor:
    return x.to(torch.int64).reshape(-1).expand(R)


def spray_select_rows_plain(j: torch.Tensor, c: torch.Tensor, sa: torch.Tensor,
                            sb: torch.Tensor, count: int, *, ell: int,
                            method: int) -> torch.Tensor:
    """Plain PyTorch version of the row-base form: the counters
    ``(j[r] + i) & M32`` for ``i < count``, then `spray_select_plain`."""
    R = c.shape[0]
    lanes = torch.arange(count, dtype=torch.int64, device=c.device)
    counters = (_per_row(j, R).unsqueeze(-1) + lanes) & M32
    seeds = torch.stack([_per_row(sa, R), _per_row(sb, R)], dim=-1)
    return spray_select_plain(counters, c, seeds, ell=ell, method=method)


def _check_common(c, R, B, ell, method):
    if c.dim() != 2 or c.shape[0] != R:
        raise ValueError(f"c must be [R={R}, n], got {tuple(c.shape)}")
    if B < 1 or R < 1:
        raise ValueError("empty counter batch")
    if R * B > _MAX_DECISIONS:
        raise ValueError(f"at most {_MAX_DECISIONS} decisions a call, got {R} x {B}")
    if c.shape[1] < 1:
        raise ValueError("no paths")
    if not 1 <= ell <= 31:
        raise ValueError(f"ell must be in [1, 31], got {ell}")
    if method not in (0, 1, 2, 3):
        raise ValueError(f"unknown spray method {method}")


def _check(counters, c, seeds, ell, method):
    if counters.dim() != 2 or c.dim() != 2 or seeds.dim() != 2:
        raise ValueError("spray_select takes counters [R, B], c [R, n], seeds [R, 2]")
    R, B = counters.shape
    if c.shape[0] != R or seeds.shape != (R, 2):
        raise ValueError(f"row mismatch: counters {tuple(counters.shape)}, "
                         f"c {tuple(c.shape)}, seeds {tuple(seeds.shape)}")
    _check_common(c, R, B, ell, method)


def _check_rows(j, c, sa, sb, count, ell, method):
    if c.dim() != 2:
        raise ValueError(f"spray_select_rows takes c [R, n], got {tuple(c.shape)}")
    R = c.shape[0]
    for name, x in (("j", j), ("sa", sa), ("sb", sb)):
        if x.dim() > 1 or (x.dim() == 1 and x.shape[0] not in (1, R)):
            raise ValueError(f"{name} must be [R={R}] or a scalar, got {tuple(x.shape)}")
    _check_common(c, R, count, ell, method)


@functools.cache
def _launcher():
    """The kernel's C entry point, built and bound at the first CUDA call."""
    from repro_torch.kernels.build import load

    fn = load("spray_select").spray_select_launch
    ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [p, i, ll, ll, i, p, ll, p, p, i, ll, ll, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _ints(x: torch.Tensor) -> torch.Tensor:
    """``x`` if the kernel reads its dtype as it is, else an int64 copy."""
    return x if x.dtype in (torch.int32, torch.int64) else x.to(torch.int64)


def _row_stride(x: torch.Tensor) -> int:
    """The element stride between rows of a 0-d or ``[R]`` tensor (0: one
    value for every row)."""
    return x.stride(0) if x.dim() == 1 and x.shape[0] > 1 else 0


def _launch(ctr, ctr_row, ctr_col, lane_step, c, sa, sb, sa_row, sb_row, B, ell, method):
    dev = c.device
    if any(t.device != dev for t in (ctr, sa, sb)):
        raise ValueError("spray_select: all tensors must be on one CUDA device or the CPU")
    if c.dtype != torch.int32 or c.stride(1) != 1:
        c = c.to(torch.int32).contiguous()
    if sa.dtype != sb.dtype:
        sa, sb = sa.to(torch.int64), sb.to(torch.int64)
    R, n = c.shape
    out = torch.empty((R, B), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(ctr.data_ptr(), int(ctr.dtype == torch.int64), ctr_row, ctr_col,
                      lane_step, c.data_ptr(), c.stride(0), sa.data_ptr(), sb.data_ptr(),
                      int(sa.dtype == torch.int64), sa_row, sb_row, out.data_ptr(),
                      R, B, n, int(ell), int(method), stream)
    if err != 0:
        raise RuntimeError(f"spray_select launch failed with CUDA error {err}")
    count_launch(spray_select)
    return out


def spray_select(counters: torch.Tensor, c: torch.Tensor, seeds: torch.Tensor,
                 *, ell: int, method: int) -> torch.Tensor:
    """Paths int32[R, B] for explicit counters; launches the CUDA kernel
    for CUDA tensors."""
    _check(counters, c, seeds, ell, method)
    if counters.device.type == "cpu":
        if c.device.type != "cpu" or seeds.device.type != "cpu":
            raise ValueError("spray_select: all tensors must be on one CUDA device or the CPU")
        return spray_select_plain(counters, c, seeds, ell=ell, method=int(method))
    if counters.device.type != "cuda":
        raise ValueError("spray_select: all tensors must be on one CUDA device or the CPU")
    ctr, seeds = _ints(counters), _ints(seeds)
    return _launch(ctr, ctr.stride(0), ctr.stride(1), 0, c, seeds[:, 0], seeds[:, 1],
                   seeds.stride(0), seeds.stride(0), counters.shape[1], ell, method)


def spray_select_rows(j: torch.Tensor, c: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor,
                      count: int, *, ell: int, method: int) -> torch.Tensor:
    """Paths int32[R, count] for the counters ``(j[r] + i) mod 2**32``,
    ``i < count``, with ``j``, ``sa``, ``sb`` each ``[R]`` or a scalar;
    launches the CUDA kernel (one device operation) for CUDA tensors."""
    _check_rows(j, c, sa, sb, count, ell, method)
    if c.device.type == "cpu":
        if any(t.device.type != "cpu" for t in (j, sa, sb)):
            raise ValueError("spray_select: all tensors must be on one CUDA device or the CPU")
        return spray_select_rows_plain(j, c, sa, sb, count, ell=ell, method=int(method))
    if c.device.type != "cuda":
        raise ValueError("spray_select: all tensors must be on one CUDA device or the CPU")
    j, sa, sb = _ints(j), _ints(sa), _ints(sb)
    return _launch(j, _row_stride(j), 0, 1, c, sa, sb, _row_stride(sa), _row_stride(sb),
                   count, ell, method)


spray_select.launches = 0
