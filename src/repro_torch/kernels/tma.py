"""What a tensor map (TMA, ``csrc/sm90.cuh``) can read in place, and the
copy that makes any other view readable; shared by the kernels that load
their operands through tensor maps (`flash_attention`'s bf16 route and
`flash_decode`)."""
from __future__ import annotations

import torch

__all__ = ["ALIGN", "ready", "aligned_copy"]

ALIGN = 16  # bytes: a tensor map's base and strides


def ready(t: torch.Tensor) -> bool:
    """TMA can read ``t`` as it is: unit last stride, 16-byte-aligned base,
    every other stride of an axis longer than one a positive multiple of 16
    bytes."""
    if t.stride(-1) != 1 or t.data_ptr() % ALIGN:
        return False
    size = t.element_size()
    return all(n == 1 or (s > 0 and (s * size) % ALIGN == 0)
               for n, s in zip(t.shape[:-1], t.stride()[:-1]))


def aligned_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy with the last axis padded with zeros to a whole
    number of 16 bytes, so that every stride is a multiple of 16 bytes."""
    D = t.shape[-1]
    per = ALIGN // t.element_size()
    out = torch.zeros((*t.shape[:-1], -(-D // per) * per), dtype=t.dtype, device=t.device)
    out[..., :D] = t
    return out[..., :D]
