"""Ordered per-link sums of the shared fabric: the port's `link_fold` kernel.

The shared fabric sums every (hop, flow, path) value onto the link it
crosses.  The reference does it with an XLA scatter-add
(`repro/net/topology.py` `_link_sum`; there is no Pallas kernel behind
it), and its bits fix the order of the additions: each link's values fold
onto the link's base value in ascending flattened (hop, flow, path)
order.  `link_segments` lists those entries once per routing matrix as a
CSR (`LinkSegments`), and

    link_fold(vals, seg, base)[l] = base[l] + vals[i_l0] + vals[i_l1] + ...

left to right.  `link_fold_plain` is the plain version: one gather and one
add per entry of the deepest link over a padded ``[L, depth]`` index
(padding reads a zero).  `link_fold` runs it on CPU tensors and launches
the CUDA kernel (``csrc/link_fold.cu``, one launch a call, reading the
unpadded CSR) on CUDA tensors; a CUDA tensor never falls back to the plain
version.  Never replace either with `index_add_` on floats: its order of
additions is not this one.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import count_launch

__all__ = ["LinkSegments", "link_segments", "link_fold", "link_fold_plain"]


@dataclasses.dataclass(frozen=True)
class LinkSegments:
    """The routing matrix as a CSR: link l's entries are
    ``index[offsets[l]:offsets[l + 1]]``, flattened (hop, flow, path)
    indices in ascending order."""

    offsets: torch.Tensor  # int32[L + 1]
    index: torch.Tensor    # int32[N] link-major, ascending within a link
    entries: int           # N = the routing matrix's size
    depth: int             # the most entries any link has

    @property
    def links(self) -> int:
        return int(self.offsets.shape[0]) - 1

    @functools.cached_property
    def padded(self) -> torch.Tensor:
        """int64[L, max(depth, 1)]: row l lists link l's entries, padded
        with ``entries`` (the plain version reads a zero there)."""
        offsets = self.offsets.cpu().numpy().astype(np.int64)
        counts = np.diff(offsets)
        out = np.full((self.links, max(self.depth, 1)), self.entries, np.int64)
        rows = np.repeat(np.arange(self.links), counts)
        pos = np.arange(int(offsets[-1])) - np.repeat(offsets[:-1], counts)
        out[rows, pos] = self.index.cpu().numpy()
        return torch.as_tensor(out, device=self.index.device)


def link_segments(route: torch.Tensor, links: int) -> LinkSegments:
    """The CSR of ``route`` (int[..., ] link ids, any shape) over ``links``
    links, on the route's device."""
    flat = route.reshape(-1).cpu().numpy().astype(np.int64)
    if flat.size and (flat.min() < 0 or flat.max() >= links):
        raise ValueError(f"route holds link ids outside [0, {links})")
    if flat.size >= 2 ** 31:
        raise ValueError("the kernel indexes entries in 32 bits")
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=links)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    dev = route.device
    return LinkSegments(offsets=torch.as_tensor(offsets, device=dev),
                        index=torch.as_tensor(order.astype(np.int32), device=dev),
                        entries=int(flat.size),
                        depth=int(counts.max()) if counts.size else 0)


def link_fold_plain(vals: torch.Tensor, seg: LinkSegments,
                    base: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: base plus one gather per entry of the
    deepest link, added in order: [L]."""
    flat = torch.cat([vals.reshape(-1), vals.new_zeros(1)])
    index = seg.padded
    acc = base
    for k in range(seg.depth):
        acc = acc + flat[index[:, k]]
    return acc


def _check(vals, seg, base):
    if vals.numel() != seg.entries:
        raise ValueError(f"link_fold: {vals.numel()} values for a routing matrix of "
                         f"{seg.entries} entries")
    if base.shape != (seg.links,):
        raise ValueError(f"link_fold: base must be [{seg.links}], got {tuple(base.shape)}")
    if vals.dtype != torch.float32 or base.dtype != torch.float32:
        raise TypeError(f"link_fold sums float32, got {vals.dtype} and {base.dtype}")


@functools.cache
def _launcher():
    """The kernel's C entry point, built and bound at the first CUDA call."""
    from repro_torch.kernels.build import load

    fn = load("link_fold").link_fold_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def link_fold(vals: torch.Tensor, seg: LinkSegments, base: torch.Tensor) -> torch.Tensor:
    """``base[l]`` plus link l's values in ascending flattened order, as a
    float32 [L]; launches the CUDA kernel for CUDA tensors."""
    _check(vals, seg, base)
    tensors = (vals, base, seg.offsets, seg.index)
    if vals.device.type == "cpu":
        if any(t.device.type != "cpu" for t in tensors):
            raise ValueError("link_fold: all tensors must be on one CUDA device or the CPU")
        return link_fold_plain(vals, seg, base)
    if vals.device.type != "cuda" or any(t.device != vals.device for t in tensors):
        raise ValueError("link_fold: all tensors must be on one CUDA device or the CPU")
    vals, base = vals.contiguous(), base.contiguous()
    out = torch.empty_like(base)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    err = _launcher()(vals.data_ptr(), seg.offsets.data_ptr(), seg.index.data_ptr(),
                      base.data_ptr(), out.data_ptr(), seg.links, seg.depth, stream)
    if err != 0:
        raise RuntimeError(f"link_fold launch failed with CUDA error {err}")
    count_launch(link_fold)
    return out


link_fold.launches = 0
