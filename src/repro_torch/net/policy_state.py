"""Per-policy sender state blocks (PRIME, STrack, CC-coupled spraying).

Every block is per path, ``[*lead, n]`` when enabled and zero-width
``[*lead, 0]`` when not.  The update folds each tick's delayed feedback
into every enabled block and draws no random numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from repro_torch.numerics import fma32
from repro_torch.random import M32, mul32

__all__ = ["BLOCKS", "PolicyState", "canon_blocks", "init_policy_state",
           "update_policy_state", "entropy_mix"]

BLOCKS: Tuple[str, ...] = ("rtt", "penalty", "entropy", "ccw")

RTT_EWMA = 0.25
PEN_DECAY = 0.9375
PEN_ECN_W = 1.0
PEN_LOSS_W = 4.0
ENT_ECN_THRESH = 0.25
ENT_LOSS_THRESH = 0.05
CCW_INIT = 4.0
CCW_MIN = 0.125
CCW_MAX = 32.0
CC_BETA = 0.5
CC_ALPHA = 0.25


@dataclasses.dataclass(frozen=True)
class PolicyState:
    rtt: torch.Tensor      # float32[*lead, n?]
    penalty: torch.Tensor  # float32[*lead, n?]
    entropy: torch.Tensor  # int64[*lead, n?] holding uint32
    ccw: torch.Tensor      # float32[*lead, n?]


def canon_blocks(blocks: Sequence[str]) -> Tuple[str, ...]:
    unknown = set(blocks) - set(BLOCKS)
    if unknown:
        raise ValueError(f"unknown policy-state block(s) {sorted(unknown)}; known: {BLOCKS}")
    return tuple(b for b in BLOCKS if b in set(blocks))


def entropy_mix(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 avalanche hash on uint32 values (held in int64)."""
    x = x & M32
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def init_policy_state(blocks: Sequence[str], lead: Tuple[int, ...], n: int, *,
                      latency: torch.Tensor, sa: torch.Tensor) -> PolicyState:
    """Initial blocks: RTT from the base latency, PRIME entropy slots hashed
    from the flow's spray seed, windows at CCW_INIT; disabled blocks are
    zero-width."""
    blocks = set(canon_blocks(blocks))
    dev = latency.device
    full = lead + (n,)

    def width(name):
        return n if name in blocks else 0

    lat = torch.broadcast_to(latency.to(torch.float32), full)
    slots = torch.arange(n, dtype=torch.int64, device=dev)
    ent = entropy_mix(mul32(sa.to(torch.int64).unsqueeze(-1), 0x9E3779B9)
                      + mul32(slots, 0x85EBCA6B) + 1)
    ent = torch.broadcast_to(ent, full)
    return PolicyState(
        rtt=lat[..., :width("rtt")].clone(),
        penalty=torch.zeros(lead + (width("penalty"),), device=dev),
        entropy=ent[..., :width("entropy")].clone(),
        ccw=torch.full(lead + (width("ccw"),), CCW_INIT, device=dev),
    )


def update_policy_state(state: PolicyState, *, ecn_rate, loss_rate, rtt_sample,
                        seen) -> PolicyState:
    rtt, pen, ent, ccw = state.rtt, state.penalty, state.entropy, state.ccw
    if rtt.shape[-1]:
        rtt = torch.where(seen, rtt + RTT_EWMA * (rtt_sample - rtt), rtt)
    if pen.shape[-1]:
        # XLA fuses the decay's multiply into the add (one rounding); the
        # two weights are exact powers of two
        pen = fma32(pen, torch.full_like(pen, PEN_DECAY), PEN_ECN_W * ecn_rate) \
            + PEN_LOSS_W * loss_rate
    if ent.shape[-1]:
        n = ent.shape[-1]
        bad = (ecn_rate > ENT_ECN_THRESH) | (loss_rate > ENT_LOSS_THRESH)
        slot_bad = torch.gather(bad, -1, ent % n)
        ent = torch.where(slot_bad, entropy_mix(ent), ent)
    if ccw.shape[-1]:
        congested = ecn_rate + loss_rate
        dec = ccw * (1.0 - CC_BETA * torch.clamp_max(congested, 1.0))
        ccw = torch.clamp(torch.where(congested > 0.0, dec, ccw + CC_ALPHA),
                          CCW_MIN, CCW_MAX)
    return PolicyState(rtt=rtt, penalty=pen, entropy=ent, ccw=ccw)
