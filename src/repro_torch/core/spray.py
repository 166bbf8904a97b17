"""Whack-a-Mole packet spraying (paper §4): spray keys and path selection.

For spray counter j and seed (sa, sb) the selection point is

  * PLAIN     : theta(j)
  * SHUFFLE_1 : theta(sa + j*sb mod m)
  * SHUFFLE_2 : (sa + sb*theta(j)) mod m
  * COMBINED  : SHUFFLE_1's key fed through SHUFFLE_2's post-mix with a
                second seed derived from the first

and the path is the smallest i with c(i-1) <= key < c(i).  Counters and
seeds are uint32 values held in int64 tensors; all arithmetic is exact.

`spray_paths` / `spray_batch` spray one source's next packets through the
`spray_select` kernel (one row) and stamp the per-path sequence numbers
of the packet headers (§5).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import torch

from repro_torch.core.bitrev import theta
from repro_torch.core.profile import PathProfile
from repro_torch.random import M32, mul32

__all__ = ["SprayMethod", "SprayState", "make_spray_state", "spray_key", "select_path",
           "spray_paths", "spray_batch", "reseed"]


class SprayMethod(enum.IntEnum):
    PLAIN = 0
    SHUFFLE_1 = 1
    SHUFFLE_2 = 2
    COMBINED = 3


@dataclasses.dataclass(frozen=True)
class SprayState:
    """Spray counters and seeds (int64 holding uint32): one per flow in the
    sender engine, scalars for one source (`make_spray_state`), which also
    carries the next per-path sequence numbers ``path_seq`` (int32[n])."""

    j: torch.Tensor
    sa: torch.Tensor
    sb: torch.Tensor
    ell: int
    method: int
    path_seq: torch.Tensor | None = None

    @property
    def m(self) -> int:
        return 1 << self.ell


def spray_key(j, sa, sb, ell: int, method: int) -> torch.Tensor:
    """Selection points in [0, m) for counters j (seeds broadcast against j).

    Only the low ell bits of each product and sum survive the final mask,
    so operands are masked first and every product stays inside int64."""
    mask = (1 << ell) - 1
    j, sa, sb = j & M32, sa & M32, sb & M32
    if method == SprayMethod.PLAIN:
        return theta(j, ell)
    if method == SprayMethod.SHUFFLE_1:
        return theta((sa + (j & mask) * (sb & mask)) & mask, ell)
    if method == SprayMethod.SHUFFLE_2:
        return ((sa & mask) + (sb & mask) * theta(j, ell)) & mask
    if method == SprayMethod.COMBINED:
        sa2 = theta(sa, ell)
        sb2 = (mul32(sb, 0x9E37) | 1) & mask
        inner = theta((sa + (j & mask) * (sb & mask)) & mask, ell)
        return (sa2 + sb2 * inner) & mask
    raise ValueError(f"unknown spray method {method}")


def select_path(c: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Smallest i with key < c(i), as the count #{i : c(i) <= key}.

    ``c`` is ``[..., n]`` and ``key`` ``[..., B]`` with matching leading
    axes; returns int32 ``[..., B]``."""
    hits = c.to(torch.int64).unsqueeze(-2) <= key.to(torch.int64).unsqueeze(-1)
    return hits.sum(dim=-1, dtype=torch.int32)


def make_spray_state(profile: PathProfile, *, method: SprayMethod = SprayMethod.SHUFFLE_1,
                     sa: int = 0, sb: int = 1, j0: int = 0) -> SprayState:
    """One source's spray state on the profile's device; sb must be odd."""
    m = profile.m
    if not (0 <= sa < m):
        raise ValueError(f"sa must be in [0, m={m}), got {sa}")
    if not (1 <= sb < m) or sb % 2 == 0:
        raise ValueError(f"sb must be odd in [1, m={m}), got {sb}")
    dev = profile.b.device
    return SprayState(
        j=torch.tensor(j0 & M32, dtype=torch.int64, device=dev),
        sa=torch.tensor(sa, dtype=torch.int64, device=dev),
        sb=torch.tensor(sb, dtype=torch.int64, device=dev),
        ell=profile.ell, method=int(method),
        path_seq=torch.zeros(profile.n, dtype=torch.int32, device=dev))


def spray_paths(state: SprayState, profile: PathProfile, count: int) -> torch.Tensor:
    """Paths int32[count] of the next `count` packets (no state update),
    from one row of the `spray_select` kernel's row-base form: one device
    operation on a CUDA device."""
    from repro_torch.kernels.spray_select import spray_select_rows  # imports this module

    return spray_select_rows(state.j, profile.c.reshape(1, -1), state.sa, state.sb, count,
                             ell=state.ell, method=state.method)[0]


def spray_batch(state: SprayState, profile: PathProfile,
                count: int) -> Tuple[torch.Tensor, torch.Tensor, SprayState]:
    """Spray `count` packets: (paths[count], seqs[count], new state), where
    seqs are the per-path sequence numbers stamped into the headers."""
    paths = spray_paths(state, profile, count)
    idx = paths.to(torch.int64)
    # hits[i, k]: packet k takes path i; the scan runs along the contiguous
    # packet axis (a scan down the other axis is far slower on the card)
    hits = (torch.arange(profile.n, device=paths.device).unsqueeze(-1) == idx).to(torch.int32)
    upto = torch.cumsum(hits, dim=1, dtype=torch.int32)  # [n, count], inclusive
    seqs = state.path_seq[idx] + upto.gather(0, idx.unsqueeze(0))[0] - 1
    new_state = dataclasses.replace(state, j=(state.j + count) & M32,
                                    path_seq=state.path_seq + upto[:, -1])
    return paths, seqs, new_state


def reseed(state: SprayState, sa: int, sb: int) -> SprayState:
    """Change the seed (paper §4), reduced mod m with sb made odd."""
    mask = state.m - 1
    dev = state.j.device
    return dataclasses.replace(
        state, sa=torch.tensor(sa & M32 & mask, dtype=torch.int64, device=dev),
        sb=torch.tensor(((sb & M32) | 1) & mask, dtype=torch.int64, device=dev))
