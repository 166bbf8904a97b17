"""Independent-bundle multipath fabric (paper §2), one tick at a time.

Each flow sees n paths with a capacity, a base latency, a tail-drop FIFO,
an ECN threshold and a Markov on/off degradation (the moles).  Per-path
statistics come back to the source `fb_delay` ticks later.  State tensors
carry a leading flow axis ``lead``; ticks are functional (a new state is
returned and the old one is left as it was).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["FabricParams", "FabricState", "init_fabric", "fabric_tick",
           "ring_deposit", "feedback_rings"]


@dataclasses.dataclass(frozen=True)
class FabricParams:
    capacity: torch.Tensor        # float32[n]
    latency: torch.Tensor         # int32[n]
    queue_limit: torch.Tensor     # float32[n]
    ecn_threshold: torch.Tensor   # float32[n]
    degrade_p: torch.Tensor       # float32[n]
    recover_p: torch.Tensor       # float32[n]
    degrade_factor: torch.Tensor  # float32[n]
    fb_delay: int
    ring_len: int

    @property
    def n(self) -> int:
        return int(self.capacity.shape[0])


@dataclasses.dataclass(frozen=True)
class FabricState:
    queue: torch.Tensor        # float32[*lead, n]
    degraded: torch.Tensor     # bool[*lead, n]
    arrive_ring: torch.Tensor  # float32[*lead, ring_len]
    sent_ring: torch.Tensor    # float32[*lead, fbwin, n]
    mark_ring: torch.Tensor
    drop_ring: torch.Tensor
    qdelay_ring: torch.Tensor
    received: torch.Tensor     # float32[*lead]
    dropped: torch.Tensor      # float32[*lead, n]
    t: int


def init_fabric(params: FabricParams, lead_shape: Tuple[int, ...] = ()) -> FabricState:
    n, fbwin = params.n, params.fb_delay
    dev = params.capacity.device

    def z(*shape, dtype=torch.float32):
        return torch.zeros(lead_shape + shape, dtype=dtype, device=dev)

    return FabricState(
        queue=z(n), degraded=z(n, dtype=torch.bool), arrive_ring=z(params.ring_len),
        sent_ring=z(fbwin, n), mark_ring=z(fbwin, n), drop_ring=z(fbwin, n),
        qdelay_ring=z(fbwin, n), received=z(), dropped=z(n), t=0,
    )


def ring_deposit(ring: torch.Tensor, slot: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Add vals[..., p] into ring[..., slot[..., p]], folding onto the ring
    path by path in ascending order: the association XLA gives both the
    one-hot deposit of `fabric_tick` and the scatter of the shared fabric.
    Each step writes distinct slots, so no atomics are involved."""
    acc = ring.clone()
    for p in range(slot.shape[-1]):
        idx = slot[..., p:p + 1].to(torch.int64)
        acc.scatter_(-1, idx, torch.gather(acc, -1, idx) + vals[..., p:p + 1])
    return acc


def feedback_rings(state, w: int, **new):
    """Read row w of each feedback ring, then overwrite it with `new`."""
    fb, rings = {}, {}
    for name, key in (("sent_ring", "sent"), ("mark_ring", "marked"),
                      ("drop_ring", "dropped"), ("qdelay_ring", "qdelay")):
        ring = getattr(state, name)
        fb[key] = ring[..., w, :].clone()
        ring = ring.clone()
        ring[..., w, :] = new[key]
        rings[name] = ring
    return fb, rings


def fabric_tick(params: FabricParams, state: FabricState, arrivals: torch.Tensor,
                u: torch.Tensor):
    """Advance one tick; returns (state', fb), fb holding what the source
    sent `fb_delay` ticks ago.  ``u`` is this tick's mole draw, shaped like
    ``state.degraded``: ``random.uniform(key, (n,))`` for the tick's key
    (the sender draws a whole horizon of them in one call)."""
    t = state.t
    go_down = (~state.degraded) & (u < params.degrade_p)
    go_up = state.degraded & (u < params.recover_p)
    degraded = (state.degraded | go_down) & ~go_up
    cap = params.capacity * torch.where(degraded, params.degrade_factor,
                                        torch.ones_like(params.degrade_factor))

    q_in = state.queue + arrivals
    drops = torch.clamp_min(q_in - params.queue_limit, 0.0)
    q_in = torch.minimum(q_in, params.queue_limit)

    served = torch.minimum(q_in, cap)
    queue = q_in - served
    qdelay = torch.where(cap > 0, queue / torch.clamp_min(cap, 1e-6),
                         torch.zeros_like(queue))
    delay = params.latency + torch.round(qdelay).to(torch.int32)
    delay = torch.clamp_max(delay, params.ring_len - 1)
    slot = (t + 1 + delay) % params.ring_len
    ring = ring_deposit(state.arrive_ring, slot, served)

    cur = t % params.ring_len
    landed = ring[..., cur].clone()
    ring[..., cur] = 0.0
    received = state.received + landed
    marked = torch.where(queue > params.ecn_threshold, served, torch.zeros_like(served))

    fb, rings = feedback_rings(state, t % params.fb_delay, sent=arrivals,
                               marked=marked, dropped=drops, qdelay=qdelay)
    fb["landed"] = landed
    new = FabricState(queue=queue, degraded=degraded, arrive_ring=ring,
                      received=received, dropped=state.dropped + drops,
                      t=t + 1, **rings)
    return new, fb

