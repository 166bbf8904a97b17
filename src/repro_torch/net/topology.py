"""Shared-fabric engine: flows that contend on shared links.

F flows map their n logical paths onto shared links through a routing
matrix ``route[hop, flow, path] -> link``; every link runs one fluid FIFO
with tail drop and ECN, fed by the sum of all traffic crossing it.  Two
builders make the matrix: `leaf_spine` (2 hops) and `fat_tree` (4 hops over
a 3-tier multi-pod Clos, `FatTreeGrid`).

Float association follows the jitted reference exactly:

  * a per-link sum folds the (hop, flow, path) contributions onto the
    link's base value (background backlog or arrivals) in ascending
    flattened order (`LinkSegments`, the `link_fold` kernel on the card);
  * deliveries fold onto the arrival ring path by path in ascending order;
  * a multiply that XLA fuses into the add or subtract consuming it is one
    rounding (`numerics.fma32`).

Both are gathers plus fixed-order folds, with no atomics, so the CPU and
the card give the same bits.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels.link_fold import LinkSegments, link_fold, link_segments
from repro_torch.net.fabric import feedback_rings, ring_deposit
from repro_torch.numerics import fma32, fold_sum

__all__ = ["TopologyParams", "EventSchedule", "SharedFabricState", "LinkSegments",
           "leaf_spine", "FatTreeGrid", "fat_tree", "null_schedule", "uplink_id",
           "downlink_id", "init_shared_fabric", "link_segments", "scatter_delivery",
           "shared_fabric_tick", "single_flow_stepper", "link_backlog",
           "link_telemetry"]


@dataclasses.dataclass(frozen=True)
class TopologyParams:
    route: torch.Tensor           # int32[H, F, n] link id at each hop
    capacity: torch.Tensor        # float32[L]
    queue_limit: torch.Tensor     # float32[L]
    ecn_threshold: torch.Tensor   # float32[L]
    latency: torch.Tensor         # int32[F, n]
    degrade_p: torch.Tensor       # float32[L]
    recover_p: torch.Tensor       # float32[L]
    degrade_factor: torch.Tensor  # float32[L]
    fb_delay: int
    ring_len: int

    @property
    def hops(self) -> int:
        return int(self.route.shape[0])

    @property
    def flows(self) -> int:
        return int(self.route.shape[1])

    @property
    def n(self) -> int:
        return int(self.route.shape[2])

    @property
    def links(self) -> int:
        return int(self.capacity.shape[0])

    @functools.cached_property
    def segments(self) -> "LinkSegments":
        return link_segments(self.route, self.links)


@dataclasses.dataclass(frozen=True)
class EventSchedule:
    """Per-tick events; tick t reads row min(t, T-1)."""

    cap_scale: torch.Tensor    # float32[T, L]
    bg_arrivals: torch.Tensor  # float32[T, L]

    @property
    def horizon(self) -> int:
        return int(self.cap_scale.shape[0])


def null_schedule(links: int, horizon: int = 1, device=None) -> EventSchedule:
    return EventSchedule(
        cap_scale=torch.ones((horizon, links), device=device),
        bg_arrivals=torch.zeros((horizon, links), device=device),
    )


def uplink_id(leaf, spine, n_leaves: int, n_spines: int):
    return leaf * n_spines + spine


def downlink_id(spine, leaf, n_leaves: int, n_spines: int):
    return n_leaves * n_spines + spine * n_leaves + leaf


def leaf_spine(n_leaves: int, n_spines: int, flow_pairs, *,
               uplink_capacity: float = 8.0, downlink_capacity: float | None = None,
               queue_limit: float = 48.0, ecn_threshold: float = 12.0,
               latency_ticks: int = 4, degrade_p: float = 0.0,
               recover_p: float = 0.05, degrade_factor: float = 0.05,
               fb_delay: int = 8, ring_len: int = 128, device=None) -> TopologyParams:
    """2-tier leaf-spine: flow (src, dst) gets n = n_spines paths; path p
    rides uplink(src, p) then downlink(p, dst).  Uplinks come first
    (leaf-major), then downlinks (spine-major)."""
    if downlink_capacity is None:
        downlink_capacity = uplink_capacity
    pairs = np.asarray(flow_pairs, dtype=np.int32)
    if pairs.ndim != 2 or pairs.shape[1] != 2:
        raise ValueError("flow_pairs must be a sequence of (src, dst) leaves")
    if np.any(pairs < 0) or np.any(pairs >= n_leaves):
        raise ValueError("flow endpoints out of leaf range")
    if np.any(pairs[:, 0] == pairs[:, 1]):
        raise ValueError("intra-leaf flows never reach the spine layer")
    F, n = pairs.shape[0], n_spines
    spines = np.arange(n_spines, dtype=np.int32)
    up = uplink_id(pairs[:, :1], spines[None, :], n_leaves, n_spines)
    down = downlink_id(spines[None, :], pairs[:, 1:], n_leaves, n_spines)
    route = np.stack([up, down], axis=0).astype(np.int32)
    half = n_leaves * n_spines
    L = 2 * half
    cap = np.concatenate([np.full(half, uplink_capacity, np.float32),
                          np.full(half, downlink_capacity, np.float32)])

    def full(v, shape=(L,), dtype=np.float32):
        return torch.as_tensor(np.full(shape, v, dtype), device=device)

    return TopologyParams(
        route=torch.as_tensor(route, device=device),
        capacity=torch.as_tensor(cap, device=device),
        queue_limit=full(queue_limit), ecn_threshold=full(ecn_threshold),
        latency=full(latency_ticks, (F, n), np.int32),
        degrade_p=full(degrade_p), recover_p=full(recover_p),
        degrade_factor=full(degrade_factor),
        fb_delay=fb_delay, ring_len=ring_len,
    )


@dataclasses.dataclass(frozen=True)
class FatTreeGrid:
    """Host-side descriptor of a 3-tier fat-tree (multi-pod Clos).

    Pods of `leaves_per_pod` leaves and `spines_per_pod` spines; spine s of
    every pod connects to the `cores_per_spine` cores of core plane s.  An
    inter-pod flow has n = spines_per_pod * cores_per_spine 4-hop paths:
    path (s, j) climbs leaf -> spine s -> core (s, j) and descends to spine
    s of the destination pod -> leaf.  Intra-pod flows turn at the spine:
    their middle hops ride the infinite-capacity bypass link (id
    ``links - 1``), so one [hop, flow, path] matrix covers both.

    Link ids: leaf->spine uplinks [0, P*Lp*S), spine->core uplinks
    (next P*S*C), core->spine downlinks (next P*S*C), spine->leaf
    downlinks (next P*S*Lp), then the bypass.
    """

    n_pods: int
    leaves_per_pod: int
    spines_per_pod: int
    cores_per_spine: int

    def __post_init__(self):
        if min(self.n_pods, self.leaves_per_pod, self.spines_per_pod,
               self.cores_per_spine) < 1:
            raise ValueError("every fat-tree dimension must be >= 1")

    @property
    def n_leaves(self) -> int:
        return self.n_pods * self.leaves_per_pod

    @property
    def n_paths(self) -> int:
        return self.spines_per_pod * self.cores_per_spine

    @property
    def links(self) -> int:
        P, Lp = self.n_pods, self.leaves_per_pod
        S, C = self.spines_per_pod, self.cores_per_spine
        return 2 * P * Lp * S + 2 * P * S * C + 1

    @property
    def bypass(self) -> int:
        return self.links - 1

    # link id helpers, vectorised over numpy int arrays

    def up_leaf_spine(self, pod, leaf, spine):
        return (pod * self.leaves_per_pod + leaf) * self.spines_per_pod + spine

    def up_spine_core(self, pod, spine, core):
        base = self.n_pods * self.leaves_per_pod * self.spines_per_pod
        return base + (pod * self.spines_per_pod + spine) * self.cores_per_spine + core

    def down_core_spine(self, spine, core, pod):
        P, Lp = self.n_pods, self.leaves_per_pod
        S, C = self.spines_per_pod, self.cores_per_spine
        return P * Lp * S + P * S * C + (spine * C + core) * P + pod

    def down_spine_leaf(self, pod, spine, leaf):
        P, Lp = self.n_pods, self.leaves_per_pod
        S, C = self.spines_per_pod, self.cores_per_spine
        return P * Lp * S + 2 * P * S * C + (pod * S + spine) * Lp + leaf

    def pod_of(self, leaf_global):
        return leaf_global // self.leaves_per_pod

    def tier_slices(self):
        """name -> slice of the link axis, one per physical tier and the
        bypass."""
        P, Lp = self.n_pods, self.leaves_per_pod
        S, C = self.spines_per_pod, self.cores_per_spine
        edges = np.cumsum([0, P * Lp * S, P * S * C, P * S * C, P * S * Lp])
        names = ("leaf_spine_up", "spine_core_up", "core_spine_down", "spine_leaf_down")
        out = {nm: slice(int(edges[i]), int(edges[i + 1])) for i, nm in enumerate(names)}
        out["bypass"] = slice(int(edges[4]), int(edges[4]) + 1)
        return out


# capacity, queue limit and ECN threshold of the virtual bypass link:
# effectively infinite, yet far below float32's loss of integer precision
_BYPASS_CAPACITY = 1e9


def fat_tree(n_pods: int, leaves_per_pod: int, spines_per_pod: int,
             cores_per_spine: int, flow_pairs, *, uplink_capacity: float = 8.0,
             downlink_capacity: float | None = None, core_capacity: float | None = None,
             queue_limit: float = 48.0, ecn_threshold: float = 12.0,
             latency_ticks: int = 6, intra_latency_ticks: int = 4,
             degrade_p: float = 0.0, recover_p: float = 0.05,
             degrade_factor: float = 0.05, fb_delay: int = 8, ring_len: int = 128,
             device=None) -> TopologyParams:
    """3-tier fat-tree (see `FatTreeGrid`): flow (src, dst) between global
    leaves gets n = spines_per_pod * cores_per_spine paths; intra-pod path
    (s, j) collapses to spine s over the bypass.  `core_capacity` covers
    both core tiers (default `uplink_capacity`); inter-pod paths take
    `latency_ticks`, intra-pod ones `intra_latency_ticks`."""
    grid = FatTreeGrid(n_pods, leaves_per_pod, spines_per_pod, cores_per_spine)
    if downlink_capacity is None:
        downlink_capacity = uplink_capacity
    if core_capacity is None:
        core_capacity = uplink_capacity
    if n_pods < 2:
        raise ValueError("fat_tree needs >= 2 pods (a 1-pod grid has a dead core tier: "
                         "use leaf_spine)")
    pairs = np.asarray(flow_pairs, dtype=np.int32)
    if pairs.ndim != 2 or pairs.shape[1] != 2:
        raise ValueError("flow_pairs must be a sequence of (src, dst) leaves")
    if np.any(pairs < 0) or np.any(pairs >= grid.n_leaves):
        raise ValueError("flow endpoints out of leaf range")
    if np.any(pairs[:, 0] == pairs[:, 1]):
        raise ValueError("intra-leaf flows never reach the spine layer")
    F, n = pairs.shape[0], grid.n_paths
    Lp, S, C = leaves_per_pod, spines_per_pod, cores_per_spine
    src_pod, src_leaf = pairs[:, 0] // Lp, pairs[:, 0] % Lp
    dst_pod, dst_leaf = pairs[:, 1] // Lp, pairs[:, 1] % Lp
    s = np.repeat(np.arange(S, dtype=np.int32), C)[None, :]  # path q = s * C + j
    j = np.tile(np.arange(C, dtype=np.int32), S)[None, :]
    inter = (src_pod != dst_pod)[:, None]
    hop0 = grid.up_leaf_spine(src_pod[:, None], src_leaf[:, None], s)
    hop1 = np.where(inter, grid.up_spine_core(src_pod[:, None], s, j), grid.bypass)
    hop2 = np.where(inter, grid.down_core_spine(s, j, dst_pod[:, None]), grid.bypass)
    hop3 = grid.down_spine_leaf(dst_pod[:, None], s, dst_leaf[:, None])
    route = np.stack([hop0, hop1, hop2, hop3]).astype(np.int32)

    tiers = grid.tier_slices()
    L = grid.links
    cap = np.empty((L,), np.float32)
    cap[tiers["leaf_spine_up"]] = uplink_capacity
    cap[tiers["spine_core_up"]] = core_capacity
    cap[tiers["core_spine_down"]] = core_capacity
    cap[tiers["spine_leaf_down"]] = downlink_capacity
    cap[grid.bypass] = _BYPASS_CAPACITY
    qlim = np.full((L,), queue_limit, np.float32)
    ecn = np.full((L,), ecn_threshold, np.float32)
    qlim[grid.bypass] = ecn[grid.bypass] = _BYPASS_CAPACITY
    deg_p = np.full((L,), degrade_p, np.float32)
    deg_p[grid.bypass] = 0.0  # the virtual bypass never degrades
    latency = np.where(inter, np.int32(latency_ticks),
                       np.int32(intra_latency_ticks)) * np.ones((F, n), np.int32)

    def t(a):
        return torch.as_tensor(a, device=device)

    return TopologyParams(
        route=t(route), capacity=t(cap), queue_limit=t(qlim), ecn_threshold=t(ecn),
        latency=t(latency.astype(np.int32)), degrade_p=t(deg_p),
        recover_p=t(np.full((L,), recover_p, np.float32)),
        degrade_factor=t(np.full((L,), degrade_factor, np.float32)),
        fb_delay=fb_delay, ring_len=ring_len,
    )


@dataclasses.dataclass(frozen=True)
class SharedFabricState:
    queue: torch.Tensor        # float32[H, F, n]
    forward: torch.Tensor      # float32[H-1, F, n]
    bg_queue: torch.Tensor     # float32[L]
    degraded: torch.Tensor     # bool[L]
    arrive_ring: torch.Tensor  # float32[F, ring_len]
    sent_ring: torch.Tensor    # float32[F, fbwin, n]
    mark_ring: torch.Tensor
    drop_ring: torch.Tensor
    qdelay_ring: torch.Tensor
    received: torch.Tensor     # float32[F]
    dropped: torch.Tensor      # float32[F, n]
    bg_served: torch.Tensor    # float32[L]
    bg_dropped: torch.Tensor
    link_arrivals: torch.Tensor
    link_served: torch.Tensor
    link_dropped: torch.Tensor
    link_busy: torch.Tensor
    t: int


def init_shared_fabric(topo: TopologyParams) -> SharedFabricState:
    H, F, n, L = topo.hops, topo.flows, topo.n, topo.links
    fbwin = topo.fb_delay
    dev = topo.capacity.device

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return SharedFabricState(
        queue=z(H, F, n), forward=z(H - 1, F, n), bg_queue=z(L),
        degraded=z(L, dtype=torch.bool), arrive_ring=z(F, topo.ring_len),
        sent_ring=z(F, fbwin, n), mark_ring=z(F, fbwin, n),
        drop_ring=z(F, fbwin, n), qdelay_ring=z(F, fbwin, n),
        received=z(F), dropped=z(F, n), bg_served=z(L), bg_dropped=z(L),
        link_arrivals=z(L), link_served=z(L), link_dropped=z(L), link_busy=z(L),
        t=0,
    )


def _link_sum(vals: torch.Tensor, seg: LinkSegments, base: torch.Tensor) -> torch.Tensor:
    """base[l] + the values crossing link l, folded onto base in ascending
    flattened (hop, flow, path) order: [L] (the `link_fold` kernel on the
    card)."""
    return link_fold(vals, seg, base)


def scatter_delivery(arrive_ring: torch.Tensor, slot: torch.Tensor,
                     exiting: torch.Tensor) -> torch.Tensor:
    """Deposit each (flow, path)'s exiting packets into its landing slot,
    folding onto the ring in ascending path order."""
    return ring_deposit(arrive_ring, slot, exiting)


def shared_fabric_tick(topo: TopologyParams, sched: EventSchedule,
                       state: SharedFabricState, arrivals: torch.Tensor,
                       u: torch.Tensor, *, gather: Callable | None = None,
                       segments: LinkSegments | None = None):
    """Advance one tick; feedback per flow ([F, n], landed [F]).  ``u`` is
    the tick's per-link mole draw ``random.uniform(key, (L,))``.

    With ``gather`` set, the tick runs on one rank's contiguous block of a
    flow-sharded run (the reference's ``axis_name=`` / ``route_global=``):
    ``topo.route`` is the block's ``[H, F_loc, n]`` slice, ``gather(x)``
    concatenates every rank's ``x [..., F_loc, n]`` along the flow axis in
    rank order, and ``segments`` is the CSR of the whole padded route.  The
    two per-link sums fold the gathered values over ``segments``, so every
    rank computes the same link state, in the unsharded order (a padded
    flow adds an exact +0.0), and the rest indexes the block's own flows."""
    route = topo.route.to(torch.int64)
    t = state.t
    if gather is None:
        seg = topo.segments
    elif segments is None:
        raise ValueError("gather requires the padded route's segments")
    else:
        seg = segments

    go_down = (~state.degraded) & (u < topo.degrade_p)
    go_up = state.degraded & (u < topo.recover_p)
    degraded = (state.degraded | go_down) & ~go_up
    ti = min(max(t, 0), sched.horizon - 1)
    ones = torch.ones_like(topo.degrade_factor)
    cap = (topo.capacity * sched.cap_scale[ti]) * torch.where(
        degraded, topo.degrade_factor, ones)
    bg_in = sched.bg_arrivals[ti]

    inflow = torch.cat([arrivals.unsqueeze(0), state.forward], dim=0)
    q_in = state.queue + inflow
    bg_q = state.bg_queue + bg_in

    q_all, inflow_all = q_in, inflow
    if gather is not None:
        q_all, inflow_all = gather(torch.stack([q_in, inflow])).unbind(0)
    backlog = _link_sum(q_all, seg, bg_q)
    incoming = _link_sum(inflow_all, seg, bg_in)
    dropable = torch.minimum(torch.clamp_min(backlog - topo.queue_limit, 0.0), incoming)
    zero = torch.zeros_like(incoming)
    drop_frac = torch.where(incoming > 0, dropable / torch.clamp_min(incoming, 1e-9), zero)
    # XLA fuses each multiply below into the add or subtract that consumes
    # it (one rounding); `fma32` reproduces that.
    df = drop_frac[route]
    q_in = fma32(-inflow, df, q_in)
    bg_q = fma32(-bg_in, drop_frac, bg_q)
    backlog = backlog - dropable

    served_l = torch.minimum(backlog, cap)
    serve_frac = torch.where(backlog > 0, served_l / torch.clamp_min(backlog, 1e-9), zero)
    sf = serve_frac[route]
    served = q_in * sf
    queue = fma32(-q_in, sf, q_in)
    bg_queue = fma32(-bg_q, serve_frac, bg_q)
    residual = backlog - served_l

    qdelay_l = torch.where(cap > 0, residual / torch.clamp_min(cap, 1e-6), zero)
    path_qdelay = fold_sum(qdelay_l[route], dim=0)
    path_drops = inflow[0] * df[0]
    for h in range(1, topo.hops):
        path_drops = fma32(inflow[h], df[h], path_drops)
    over = residual > topo.ecn_threshold
    path_marked = over[route].any(dim=0)
    exiting = served[-1]
    marked = torch.where(path_marked, exiting, torch.zeros_like(exiting))

    delay = topo.latency + torch.round(path_qdelay).to(torch.int32)
    delay = torch.clamp_max(delay, topo.ring_len - 1)
    slot = (t + 1 + delay) % topo.ring_len
    ring = scatter_delivery(state.arrive_ring, slot, exiting)
    cur = t % topo.ring_len
    landed = ring[:, cur].clone()
    ring[:, cur] = 0.0
    received = state.received + landed

    fb, rings = feedback_rings(state, t % topo.fb_delay, sent=arrivals,
                               marked=marked, dropped=path_drops, qdelay=path_qdelay)
    fb["landed"] = landed
    new = SharedFabricState(
        queue=queue, forward=served[:-1], bg_queue=bg_queue, degraded=degraded,
        arrive_ring=ring, received=received, dropped=state.dropped + path_drops,
        bg_served=fma32(bg_q, serve_frac, state.bg_served),
        bg_dropped=fma32(bg_in, drop_frac, state.bg_dropped),
        link_arrivals=state.link_arrivals + incoming,
        link_served=state.link_served + served_l,
        link_dropped=state.link_dropped + dropable,
        link_busy=state.link_busy + (served_l > 0).to(torch.float32),
        t=t + 1, **rings,
    )
    return new, fb


def link_backlog(topo: TopologyParams, state: SharedFabricState) -> torch.Tensor:
    """Per-link backlog [L]: flow traffic on every hop plus the background."""
    return _link_sum(state.queue, topo.segments, state.bg_queue)


def link_telemetry(topo: TopologyParams, state: SharedFabricState):
    """Per-link (queue, served, dropped, ecn indicator), each [L]."""
    q = link_backlog(topo, state)
    over = (q > topo.ecn_threshold).to(torch.float32)
    return q, state.link_served, state.link_dropped, over


def single_flow_stepper(topo: TopologyParams, sched: EventSchedule):
    """(state0, stepper) for `run_message_on` over a one-flow shared
    topology: ``stepper(state, arrivals[1, n], u[links])`` is one
    `shared_fabric_tick` (the port's single-flow engine keeps the flow axis
    of 1, so feedback stays ``[1, n]``; pass ``mole_size=topo.links``)."""
    if topo.flows != 1:
        raise ValueError(f"single-flow stepper needs F=1, got F={topo.flows}")

    def stepper(state, arrivals, u):
        return shared_fabric_tick(topo, sched, state, arrivals, u)

    return init_shared_fabric(topo), stepper
