"""Correlated failure processes: SRLGs, cascading PFC, burst flaps (a copy
of the JAX package's `net/failures.py`: host numpy, bit for bit the same
arrays; the port imports nothing of the reference).

Every fault the scenario library injected before this module was
*independent* — a per-link Markov mole or a hand-written per-link schedule.
Production incidents are correlated: a spine ASIC takes out a shared-risk
link *group* at once, PFC back-pressure cascades hop-by-hop upstream across
tiers, and flaps cluster in time (one transceiver event begets a burst of
follow-ups).  This module is a library of such processes, all of which
**pre-materialize into the existing `EventSchedule` contract** — a
deterministic host-built ``float32[horizon, links]`` capacity-scale array —
so every sweep and stacking path (`stack_scenarios`, `sweep_*_scenarios`)
runs unchanged and no device code path depends on them.

Three process families:

  * **Shared-risk link groups (SRLGs)** — topology-derived groups of links
    that fail together because they share a physical risk (one spine ASIC,
    one core plane's optics, one pod's uplink cable bundle).
    `leaf_spine_srlgs` / `fat_tree_srlgs` derive the canonical groups from
    the same id arithmetic the topology constructors use (`uplink_id` /
    `FatTreeGrid` helpers, cross-checked against `tier_slices()` by the
    tests); `srlg_caps` compiles seeded ``(group, start, end, severity)``
    events into one schedule where a single event derates/zeroes the whole
    group at once.

  * **Cascading PFC storms** — back-pressure that propagates *upstream*
    hop-by-hop from a congested egress: wave w engages ``hop_delay`` ticks
    after wave w-1 with severity decayed by ``decay**w`` (pause frames
    absorb further from the root), and all waves clear together when the
    root clears.  `leaf_spine_cascade_waves` / `fat_tree_cascade_waves`
    build the tier-ordered upstream wave lists; `cascade_caps` compiles
    them.

  * **Burst flap processes** — a seeded Hawkes-style self-exciting arrival
    process (`hawkes_times`): immigrant events arrive at rate ``mu`` and
    every event spawns ``Poisson(branching)`` children at exponentially
    distributed (mean ``tau``) offsets, so flaps cluster after a parent
    event instead of arriving independently.  Event times are materialized
    ON THE HOST, once, deterministically from the seed — the resulting
    schedule is a fixed-shape array like every other.  `burst_flap_caps`
    lands each event on a (seeded) SRLG for ``flap_len`` ticks.

Composition: overlapping events on the same link multiply their capacity
scales (two 50% derates compound to 25%; any hard-down event wins), which
is associative and order-independent — compound scenarios (a cascade
triggered during an SRLG window) are just elementwise products of the
per-process schedules via `compose_caps`.

`repro_torch.net.scenarios.correlated_*_scenarios` place these processes
on the uniform bench grids.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.net.topology import FatTreeGrid, downlink_id, uplink_id

__all__ = [
    "LinkGroup",
    "leaf_spine_srlgs",
    "fat_tree_srlgs",
    "SRLGEvent",
    "srlg_caps",
    "leaf_spine_cascade_waves",
    "fat_tree_cascade_waves",
    "cascade_caps",
    "cascade_onset_ticks",
    "hawkes_times",
    "burst_flap_caps",
    "compose_caps",
]


@dataclasses.dataclass(frozen=True)
class LinkGroup:
    """A named shared-risk link group: link ids that fail as one unit."""

    name: str
    links: Tuple[int, ...]

    def __post_init__(self):
        canon = tuple(sorted(set(int(x) for x in self.links)))
        if canon != tuple(self.links):
            object.__setattr__(self, "links", canon)
        if not self.links:
            raise ValueError(f"SRLG {self.name!r} is empty")
        if self.links[0] < 0:
            raise ValueError(f"SRLG {self.name!r} has negative link ids")

    @property
    def ids(self) -> np.ndarray:
        return np.asarray(self.links, np.int64)


# --------------------------------------------------------------------------
# SRLG derivation — groups follow the topology constructors' id arithmetic


def leaf_spine_srlgs(n_leaves: int, n_spines: int) -> Dict[str, LinkGroup]:
    """Per-spine SRLGs of a 2-tier leaf–spine grid.

    Spine s's ASIC carries every uplink into it and every downlink out of
    it: one failure takes out all ``2 * n_leaves`` links at once — exactly
    the link set `scenarios._flap_caps` toggles, but as a first-class
    group that any process (hard down, derate, flap burst) can target.
    """
    groups: Dict[str, LinkGroup] = {}
    for s in range(n_spines):
        links = [uplink_id(lf, s, n_leaves, n_spines) for lf in range(n_leaves)]
        links += [downlink_id(s, lf, n_leaves, n_spines) for lf in range(n_leaves)]
        groups[f"spine{s}"] = LinkGroup(f"spine{s}", tuple(links))
    return groups


def fat_tree_srlgs(grid: FatTreeGrid) -> Dict[str, LinkGroup]:
    """The canonical shared-risk groups of a 3-tier fat-tree.

    Three group families, all derived from `FatTreeGrid`'s link id helpers
    (the tests cross-check membership against `tier_slices()`):

      * ``pod{p}_spine{s}`` — one pod-spine ASIC: the leaf->spine uplinks
        into it, its spine->core uplinks, the core->spine downlinks into
        it, and its spine->leaf downlinks.  Kills path plane s for pod p's
        flows in both directions.
      * ``core_plane{s}`` — one core plane's optics: every spine->core and
        core->spine link of plane s across ALL pods.  Removes
        `cores_per_spine` of every inter-pod flow's paths at once while
        intra-pod (bypass) traffic never notices.
      * ``pod{p}_uplinks`` — pod p's uplink cable bundle: all of pod p's
        spine->core links plus the core->spine links descending into p.
        Isolates the pod from the core (intra-pod traffic survives).
    """
    g = grid
    out: Dict[str, LinkGroup] = {}
    for p in range(g.n_pods):
        for s in range(g.spines_per_pod):
            links: List[int] = []
            links += [
                g.up_leaf_spine(p, lf, s) for lf in range(g.leaves_per_pod)
            ]
            links += [
                g.up_spine_core(p, s, j) for j in range(g.cores_per_spine)
            ]
            links += [
                g.down_core_spine(s, j, p) for j in range(g.cores_per_spine)
            ]
            links += [
                g.down_spine_leaf(p, s, lf) for lf in range(g.leaves_per_pod)
            ]
            out[f"pod{p}_spine{s}"] = LinkGroup(f"pod{p}_spine{s}", tuple(links))
    for s in range(g.spines_per_pod):
        links = []
        for p in range(g.n_pods):
            for j in range(g.cores_per_spine):
                links.append(g.up_spine_core(p, s, j))
                links.append(g.down_core_spine(s, j, p))
        out[f"core_plane{s}"] = LinkGroup(f"core_plane{s}", tuple(links))
    for p in range(g.n_pods):
        links = []
        for s in range(g.spines_per_pod):
            for j in range(g.cores_per_spine):
                links.append(g.up_spine_core(p, s, j))
                links.append(g.down_core_spine(s, j, p))
        out[f"pod{p}_uplinks"] = LinkGroup(f"pod{p}_uplinks", tuple(links))
    return out


# --------------------------------------------------------------------------
# process 1: SRLG events


@dataclasses.dataclass(frozen=True)
class SRLGEvent:
    """One correlated event: `group` runs at ``1 - severity`` of nominal
    over ``[start, end)``.  ``severity=1.0`` is a hard down."""

    group: LinkGroup
    start: int
    end: int
    severity: float = 1.0

    def __post_init__(self):
        if not 0 <= self.start < self.end:
            raise ValueError(
                f"SRLG event window [{self.start}, {self.end}) is empty"
            )
        if not 0.0 < self.severity <= 1.0:
            raise ValueError(f"severity must be in (0, 1], got {self.severity}")


def srlg_caps(
    links: int, horizon: int, events: Sequence[SRLGEvent]
) -> np.ndarray:
    """Compile SRLG events into a capacity-scale schedule.

    One seeded event derates/zeroes its WHOLE group over its window;
    overlapping events compose multiplicatively per link.  Returns
    ``float32[horizon, links]`` (all-ones rows outside every window, so
    recovery is measurable after the last event clears).
    """
    cap = np.ones((horizon, links), np.float32)
    for ev in events:
        if ev.group.ids.max() >= links:
            raise ValueError(
                f"SRLG {ev.group.name!r} references link "
                f"{int(ev.group.ids.max())} >= links={links}"
            )
        lo, hi = ev.start, min(ev.end, horizon)
        if lo >= horizon:
            raise ValueError(
                f"SRLG event on {ev.group.name!r} starts at {ev.start} "
                f">= horizon {horizon} (it would silently never fire)"
            )
        cap[lo:hi, ev.group.ids] *= np.float32(1.0 - ev.severity)
    return cap


# --------------------------------------------------------------------------
# process 2: cascading PFC storms


def leaf_spine_cascade_waves(
    n_leaves: int, n_spines: int, *, root_leaf: int = 1, root_spine: int = 0,
) -> List[LinkGroup]:
    """Upstream PFC wave list for a leaf–spine grid.

    Back-pressure starts at the congested egress (spine `root_spine` ->
    leaf `root_leaf`), pauses the uplinks feeding that spine next, then the
    spine's remaining downlinks — the same three-tier spread as the
    historical `pfc_storm` scenario, expressed as ordered wave groups a
    generic compiler (`cascade_caps`) can delay and decay per hop.
    """
    w0 = [downlink_id(root_spine, root_leaf, n_leaves, n_spines)]
    w1 = [uplink_id(lf, root_spine, n_leaves, n_spines) for lf in range(n_leaves)]
    w2 = [
        downlink_id(root_spine, lf, n_leaves, n_spines)
        for lf in range(n_leaves)
        if lf != root_leaf
    ]
    return [
        LinkGroup("cascade_root", tuple(w0)),
        LinkGroup("cascade_uplinks", tuple(w1)),
        LinkGroup("cascade_downlinks", tuple(w2)),
    ]


def fat_tree_cascade_waves(
    grid: FatTreeGrid, *, root_pod: int = 0, root_spine: int = 0,
) -> List[LinkGroup]:
    """Upstream PFC wave list for a fat-tree: four tiers deep.

    The storm roots at pod `root_pod`'s spine `root_spine` egress
    (spine->leaf downlinks), backs up into the core->spine downlinks
    feeding that spine, then the whole plane's spine->core uplinks (every
    pod pausing toward the shared cores), and finally the leaf->spine
    uplinks of plane `root_spine` across all pods — a cross-tier,
    cross-pod correlated event no independent per-link process produces.
    """
    g = grid
    w0 = [g.down_spine_leaf(root_pod, root_spine, lf)
          for lf in range(g.leaves_per_pod)]
    w1 = [g.down_core_spine(root_spine, j, root_pod)
          for j in range(g.cores_per_spine)]
    w2 = [g.up_spine_core(p, root_spine, j)
          for p in range(g.n_pods) for j in range(g.cores_per_spine)]
    w3 = [g.up_leaf_spine(p, lf, root_spine)
          for p in range(g.n_pods) for lf in range(g.leaves_per_pod)]
    return [
        LinkGroup("cascade_egress", tuple(w0)),
        LinkGroup("cascade_core_down", tuple(w1)),
        LinkGroup("cascade_core_up", tuple(w2)),
        LinkGroup("cascade_leaf_up", tuple(w3)),
    ]


def cascade_caps(
    links: int,
    horizon: int,
    waves: Sequence[LinkGroup],
    *,
    start: int,
    duration: int,
    hop_delay: int = 16,
    severity: float = 1.0,
    decay: float = 1.0,
) -> np.ndarray:
    """Compile an upstream PFC cascade into a capacity-scale schedule.

    Wave w (0-based) engages at ``start + w * hop_delay`` with severity
    ``severity * decay**w`` (pause back-pressure weakens as it spreads) and
    every wave clears together at ``start + duration`` — head-of-line
    blocking releases fabric-wide once the root drains.  Waves whose
    delayed onset falls past the clear time never engage (a long cascade
    on a short storm dies out), which the onset detector must tolerate.
    """
    if duration <= 0:
        raise ValueError(f"cascade duration must be positive, got {duration}")
    if hop_delay < 0:
        raise ValueError(f"hop_delay must be >= 0, got {hop_delay}")
    if not 0.0 < severity <= 1.0:
        raise ValueError(f"severity must be in (0, 1], got {severity}")
    if not 0.0 < decay <= 1.0:
        raise ValueError(f"decay must be in (0, 1], got {decay}")
    cap = np.ones((horizon, links), np.float32)
    end = min(start + duration, horizon)
    t = np.arange(horizon)
    for w, group in enumerate(waves):
        onset = start + w * hop_delay
        if onset >= end:
            continue  # the storm cleared before the wave arrived
        sev = severity * decay**w
        active = (t >= onset) & (t < end)
        cap[np.ix_(active, group.ids)] *= np.float32(1.0 - sev)
    return cap


def cascade_onset_ticks(
    waves: Sequence[LinkGroup], *, start: int, duration: int, hop_delay: int,
) -> np.ndarray:
    """The wave-onset ticks `cascade_caps` actually engages (closed form):
    ``start + w * hop_delay`` for every wave that fires before the clear.
    This is the oracle the grouped-onset detector is pinned against."""
    end = start + duration
    onsets = [start + w * hop_delay for w in range(len(waves))]
    return np.asarray([o for o in onsets if o < end], np.int64)


# --------------------------------------------------------------------------
# process 3: burst flaps (Hawkes-style self-exciting arrivals)


def hawkes_times(
    horizon: int,
    *,
    mu: float,
    branching: float = 0.8,
    tau: float = 32.0,
    seed: int = 0,
    max_events: int = 4096,
) -> np.ndarray:
    """Deterministic, pre-materialized Hawkes event times on ``[0, horizon)``.

    A Hawkes process is a cluster process: immigrant events arrive as a
    Poisson process at rate `mu` (events per tick), and every event —
    immigrant or child — spawns ``Poisson(branching)`` children at
    Exponential(mean `tau`) tick offsets after it.  With ``branching < 1``
    the cascade is subcritical and each immigrant's cluster is finite; the
    result is the canonical "flaps cluster after a parent event" arrival
    pattern (burstier than Poisson: the dispersion test is pinned in
    tests/test_failures.py).

    Everything is materialized HERE, on the host, from one
    `numpy.random.default_rng(seed)` stream — same seed, same times, no
    device randomness — so downstream schedules keep a fixed shape.
    Returns sorted, unique int64 ticks (generation-order breadth-first
    expansion, capped at `max_events` as a runaway guard; the cap raises
    rather than silently truncating).
    """
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    if mu <= 0:
        raise ValueError(f"immigrant rate mu must be > 0, got {mu}")
    if not 0.0 <= branching < 1.0:
        raise ValueError(
            f"branching must be in [0, 1) (subcritical), got {branching}"
        )
    if tau <= 0:
        raise ValueError(f"child offset mean tau must be > 0, got {tau}")
    rng = np.random.default_rng(seed)
    n_imm = int(rng.poisson(mu * horizon))
    frontier = list(np.sort(rng.uniform(0.0, horizon, n_imm)))
    times: List[float] = []
    while frontier:
        times.extend(frontier)
        if len(times) > max_events:
            raise ValueError(
                f"hawkes_times exceeded max_events={max_events} "
                f"(mu={mu}, branching={branching}): lower the rate or "
                "raise the cap"
            )
        children: List[float] = []
        for t0 in frontier:
            k = int(rng.poisson(branching))
            if k:
                offs = rng.exponential(tau, k)
                children.extend(t0 + o for o in offs if t0 + o < horizon)
        frontier = children
    ticks = np.unique(np.floor(np.asarray(times)).astype(np.int64))
    return ticks[(ticks >= 0) & (ticks < horizon)]


def burst_flap_caps(
    links: int,
    horizon: int,
    groups: Sequence[LinkGroup],
    times: np.ndarray,
    *,
    flap_len: int = 24,
    severity: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """Land each burst-flap event on a (seeded) SRLG for `flap_len` ticks.

    Event k at tick t derates its group over ``[t, t + flap_len)`` by
    `severity`; group choice cycles through a seeded permutation-free
    draw (`default_rng(seed).integers`) so the same parent/child cluster
    usually hammers a mix of groups — overlapping flaps on one group
    compose multiplicatively like every other process.  The final
    ``max(flap_len, 1)`` ticks before `horizon` are forced clear only by
    construction when the times allow it; callers sizing recovery
    measurements should leave headroom after the last event.
    """
    if flap_len < 1:
        raise ValueError(f"flap_len must be >= 1, got {flap_len}")
    if not groups:
        raise ValueError("burst_flap_caps needs at least one target group")
    rng = np.random.default_rng(seed)
    cap = np.ones((horizon, links), np.float32)
    times = np.asarray(times, np.int64)
    picks = rng.integers(0, len(groups), len(times))
    for t0, gi in zip(times, picks):
        group = groups[int(gi)]
        cap[t0: min(t0 + flap_len, horizon), group.ids] *= np.float32(
            1.0 - severity
        )
    return cap


# --------------------------------------------------------------------------
# composition


def compose_caps(*caps: np.ndarray) -> np.ndarray:
    """Elementwise product of capacity-scale schedules (same shape).

    Multiplication is the library's composition law — compound scenarios
    (a PFC cascade landing inside an SRLG maintenance window, flap bursts
    on an already-derated plane) are products of their per-process
    schedules, associatively and order-independently.
    """
    if not caps:
        raise ValueError("compose_caps needs at least one schedule")
    shapes = {c.shape for c in caps}
    if len(shapes) != 1:
        raise ValueError(f"schedule shapes differ: {shapes}")
    out = np.ones_like(caps[0], np.float32)
    for c in caps:
        out = out * np.asarray(c, np.float32)
    return out
