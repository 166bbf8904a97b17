"""Feedback-driven path-profile control (paper §5-6), batched over flows.

Per-path severities come from delayed ECN / loss / RTT feedback; degraded
paths are whacked down (embodiment 3, or 4 when proportional) and a
starved healthy path is restored.  `jax.lax.cond` becomes a per-flow
select: both outcomes are computed and each flow keeps its own.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.profile import PathProfile, make_profile
from repro_torch.core.updates import update_embodiment3, update_embodiment4
from repro_torch.numerics import fold_sum

__all__ = ["PathStats", "ControllerState", "severity_weights", "alpha_for_severity",
           "weighted_badness", "make_controller", "whack_down", "restore_path",
           "controller_step"]


@dataclasses.dataclass(frozen=True)
class PathStats:
    ecn_rate: torch.Tensor   # float32[..., n]
    loss_rate: torch.Tensor  # float32[..., n]
    rtt: torch.Tensor        # float32[..., n]


@dataclasses.dataclass(frozen=True)
class ControllerState:
    profile: PathProfile
    r: torch.Tensor       # int32[...] residual index
    ewma_w: torch.Tensor  # float32[..., n] smoothed severities


def make_controller(profile: PathProfile) -> ControllerState:
    lead = profile.b.shape[:-1]
    dev = profile.b.device
    return ControllerState(
        profile=profile,
        r=torch.zeros(lead, dtype=torch.int32, device=dev),
        ewma_w=torch.zeros(profile.b.shape, dtype=torch.float32, device=dev),
    )


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    # a fill on the device: ``torch.tensor(v, device=...)`` would copy from
    # the host and wait for the card
    return torch.full((), v, dtype=torch.float32, device=like.device)


def severity_weights(stats: PathStats) -> torch.Tensor:
    """w = ecn + 4 loss + clip(rtt excess over the best path, 0, 4) / 4."""
    floor = stats.rtt.min(dim=-1, keepdim=True).values
    excess = torch.where(floor > 0, (stats.rtt - floor) / floor, _f32(0.0, floor))
    return (stats.ecn_rate + 4.0 * stats.loss_rate) + torch.clamp(excess, 0.0, 4.0) / 4.0


def alpha_for_severity(w: torch.Tensor, cap: float = 0.5) -> torch.Tensor:
    """The §6 adjustment factor: clip(w, 0, 1) * cap."""
    return torch.clamp(w, 0.0, 1.0) * cap


def weighted_badness(b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The §6 objective sum_i w(i) * b(i), as a left fold of the products
    (the reference's eager sum; under `jit` XLA fuses it into FMAs)."""
    return fold_sum(w * b.to(w.dtype))


def whack_down(state: ControllerState, w: torch.Tensor, *,
               degraded_threshold: float = 0.05, proportional: bool = False,
               min_floor: int = 0) -> ControllerState:
    """Remove alpha(w) * b(i) balls from every degraded path (never the
    least-bad one) and redistribute them to the healthy set."""
    b = state.profile.b
    alpha = alpha_for_severity(w)
    degraded = w > _f32(degraded_threshold, w)
    best = torch.argmin(w, dim=-1, keepdim=True)
    degraded = degraded.scatter(-1, best, False)
    e = torch.where(degraded, (alpha * b.to(torch.float32)).to(torch.int32),
                    torch.zeros_like(b))
    e = torch.minimum(e, torch.clamp_min(b - min_floor, 0))
    update = update_embodiment4 if proportional else update_embodiment3
    b_up, r_up = update(b, state.r, e)
    take = (e > 0).any(dim=-1)
    b_new = torch.where(take.unsqueeze(-1), b_up, b)
    r_new = torch.where(take, r_up, state.r)
    return dataclasses.replace(
        state, profile=make_profile(b_new, state.profile.ell), r=r_new)


def restore_path(state: ControllerState, path: torch.Tensor,
                 beta: float = 0.125) -> ControllerState:
    """Shave floor(beta * b(i)) from every other path and give it to `path`
    ([...] int); with nothing to shave, move one ball from the largest donor."""
    b = state.profile.b
    n = b.shape[-1]
    idx = torch.arange(n, device=b.device)
    other = idx != path.unsqueeze(-1)
    zero = torch.zeros_like(b)
    e = torch.where(other, (beta * b.to(torch.float32)).to(torch.int32), zero)
    donor_b = torch.where(other, b, torch.full_like(b, -1))
    donor = torch.argmax(donor_b, dim=-1, keepdim=True)
    one = torch.clamp(torch.gather(donor_b, -1, donor), 0, 1)
    one_ball = zero.scatter(-1, donor, one)
    e = torch.where((e > 0).any(dim=-1, keepdim=True), e, one_ball)
    b_new = (b - e).scatter_add(-1, path.unsqueeze(-1).to(torch.int64),
                                e.sum(-1, keepdim=True, dtype=torch.int32))
    return dataclasses.replace(state, profile=make_profile(b_new, state.profile.ell))


def controller_step(state: ControllerState, stats: PathStats, *,
                    ewma: float = 0.5, degraded_threshold: float = 0.05,
                    recovery_threshold: float = 0.01,
                    recovery_share: float = 0.02,
                    proportional: bool = False):
    """Severities -> whack-down -> recovery probe; returns (state', w)."""
    w_inst = severity_weights(stats)
    w = ewma * w_inst + (1.0 - ewma) * state.ewma_w
    state = dataclasses.replace(state, ewma_w=w)
    state = whack_down(state, w, degraded_threshold=degraded_threshold,
                       proportional=proportional)
    b = state.profile.b
    share = b.to(torch.float32) / _f32(float(state.profile.m), w)
    starved = (w < _f32(recovery_threshold, w)) & (share < _f32(recovery_share, w))
    target = torch.argmin(torch.where(starved, share, _f32(float("inf"), w)), dim=-1)
    restored = restore_path(state, target)
    do = starved.any(dim=-1)
    b_new = torch.where(do.unsqueeze(-1), restored.profile.b, b)
    state = dataclasses.replace(state, profile=make_profile(b_new, state.profile.ell))
    return state, w
