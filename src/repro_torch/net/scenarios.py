"""Scenario library for the shared fabric: topologies plus event schedules.

Each constructor returns ``(TopologyParams, EventSchedule)``, built on the
host with numpy exactly as the reference's (`repro.net.scenarios`) and
handed over as tensors (on ``device`` when it is given).  Ported: the
leaf-spine constructors (`incast` ... `crossjob_background`,
`two_path_whack`), the uniform-grid pair family (`pair_scenarios`), the
fat-tree family (`fat_tree_scenarios`) and stacking (`stack_pytrees`,
`stack_scenarios`).  The job, cluster and correlated-failure families
need modules the port does not have yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.net.topology import (EventSchedule, FatTreeGrid, TopologyParams,
                                      downlink_id, fat_tree, leaf_spine, null_schedule,
                                      uplink_id)

__all__ = ["Scenario", "incast", "oversubscription", "link_flap", "straggler_worker",
           "pfc_storm", "crossjob_background", "two_path_whack", "SCENARIOS",
           "pair_scenarios", "PAIR_SCENARIO_NAMES", "stack_pytrees", "stack_scenarios",
           "fat_tree_scenarios", "FAT_TREE_SCENARIO_NAMES"]

Scenario = Tuple[TopologyParams, EventSchedule]


def _schedule(cap_scale: np.ndarray, bg: np.ndarray, device=None) -> EventSchedule:
    if cap_scale.shape != bg.shape:
        raise ValueError(f"schedule shape mismatch: {cap_scale.shape} vs {bg.shape}")
    return EventSchedule(
        cap_scale=torch.as_tensor(np.asarray(cap_scale, np.float32), device=device),
        bg_arrivals=torch.as_tensor(np.asarray(bg, np.float32), device=device))


def _flap_caps(n_leaves: int, n_spines: int, links: int, horizon: int, period: int,
               duty: float, spine: int) -> np.ndarray:
    """Capacity scales for one spine's links flapping on a duty cycle."""
    cap = np.ones((horizon, links), np.float32)
    down_phase = (np.arange(horizon) % period) < duty * period
    for leaf in range(n_leaves):
        cap[down_phase, uplink_id(leaf, spine, n_leaves, n_spines)] = 0.0
        cap[down_phase, downlink_id(spine, leaf, n_leaves, n_spines)] = 0.0
    return cap


def _storm_caps(n_leaves: int, n_spines: int, links: int, horizon: int, start: int,
                spread: int, duration: int) -> np.ndarray:
    """Capacity scales for a PFC pause storm spreading upstream from the
    downlink spine 0 -> leaf 1 (a wave every `spread` ticks, clearing at
    start + duration)."""
    cap = np.ones((horizon, links), np.float32)
    t = np.arange(horizon)
    end = start + duration
    waves = [
        [downlink_id(0, 1, n_leaves, n_spines)],
        [uplink_id(leaf, 0, n_leaves, n_spines) for leaf in range(n_leaves)],
        [downlink_id(0, leaf, n_leaves, n_spines) for leaf in range(n_leaves) if leaf != 1],
    ]
    for wave, wave_links in enumerate(waves):
        active = (t >= start + wave * spread) & (t < end)
        for link in wave_links:
            cap[active, link] = 0.0
    return cap


def _background_arrivals(capacity: np.ndarray, horizon: int, load: float, burst_len: int,
                         gap_len: int, seed: int) -> np.ndarray:
    """On/off bursts at `load` * capacity on half the links, with phases
    drawn from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    L = capacity.shape[0]
    hit = rng.permutation(L)[: L // 2]
    bg = np.zeros((horizon, L), np.float32)
    t = np.arange(horizon)
    cycle = burst_len + gap_len
    for link in hit:
        phase = int(rng.integers(cycle))
        on = ((t + phase) % cycle) < burst_len
        bg[on, link] = load * capacity[link]
    return bg


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _null(topo: TopologyParams) -> EventSchedule:
    return null_schedule(topo.links, device=topo.capacity.device)


def incast(k: int = 8, n_spines: int = 4, *, link_capacity: float = 8.0, **kw) -> Scenario:
    """k flows from k distinct leaves into leaf 0."""
    topo = leaf_spine(k + 1, n_spines, [(src + 1, 0) for src in range(k)],
                      uplink_capacity=link_capacity, **kw)
    return topo, _null(topo)


def oversubscription(ratio: float = 4.0, flows: int = 8, n_spines: int = 4, *,
                     host_rate: float = 32.0, **kw) -> Scenario:
    """Disjoint leaf pairs over a spine layer at 1/ratio of the host demand."""
    pairs = [(2 * f, 2 * f + 1) for f in range(flows)]
    cap = host_rate / (ratio * n_spines)
    topo = leaf_spine(2 * flows, n_spines, pairs, uplink_capacity=cap, **kw)
    return topo, _null(topo)


def link_flap(flows: int = 4, n_spines: int = 4, *, period: int = 128, duty: float = 0.5,
              spine: int = 0, horizon: int = 2048, link_capacity: float = 8.0,
              **kw) -> Scenario:
    """Spine `spine` loses every link for `duty` of each `period` ticks."""
    pairs = [(2 * f, 2 * f + 1) for f in range(flows)]
    n_leaves = 2 * flows
    topo = leaf_spine(n_leaves, n_spines, pairs, uplink_capacity=link_capacity, **kw)
    cap = _flap_caps(n_leaves, n_spines, topo.links, horizon, period, duty, spine)
    return topo, _schedule(cap, np.zeros_like(cap), kw.get("device"))


def two_path_whack(*, down_spine: int = 0, t_down: int = 64, t_up: int = 192,
                   horizon: int = 1024, link_capacity: float = 8.0, **kw) -> Scenario:
    """One flow over two spines; spine `down_spine` is dark over
    [t_down, t_up)."""
    topo = leaf_spine(2, 2, [(0, 1)], uplink_capacity=link_capacity, **kw)
    cap = np.ones((horizon, topo.links), np.float32)
    t = np.arange(horizon)
    down = (t >= t_down) & (t < t_up)
    for leaf in range(2):
        cap[down, uplink_id(leaf, down_spine, 2, 2)] = 0.0
        cap[down, downlink_id(down_spine, leaf, 2, 2)] = 0.0
    return topo, _schedule(cap, np.zeros_like(cap), kw.get("device"))


def straggler_worker(workers: int = 4, n_spines: int = 4, *, factor: float = 0.25,
                     straggler: int = 0, link_capacity: float = 8.0, **kw) -> Scenario:
    """A ring of workers; the straggler's uplinks run at `factor`."""
    pairs = [(w, (w + 1) % workers) for w in range(workers)]
    topo = leaf_spine(workers, n_spines, pairs, uplink_capacity=link_capacity, **kw)
    cap = np.ones((1, topo.links), np.float32)
    for s in range(n_spines):
        cap[0, uplink_id(straggler, s, workers, n_spines)] = factor
    return topo, _schedule(cap, np.zeros((1, topo.links), np.float32), kw.get("device"))


def pfc_storm(flows: int = 4, n_spines: int = 4, *, start: int = 48, spread: int = 32,
              duration: int = 384, horizon: int = 2048, link_capacity: float = 8.0,
              **kw) -> Scenario:
    """A pause storm from spine 0 -> leaf 1, spreading upstream."""
    pairs = [(2 * f, 2 * f + 1) for f in range(flows)]
    n_leaves = 2 * flows
    topo = leaf_spine(n_leaves, n_spines, pairs, uplink_capacity=link_capacity, **kw)
    cap = _storm_caps(n_leaves, n_spines, topo.links, horizon, start, spread, duration)
    return topo, _schedule(cap, np.zeros_like(cap), kw.get("device"))


def crossjob_background(flows: int = 4, n_spines: int = 4, *, load: float = 0.6,
                        burst_len: int = 64, gap_len: int = 64, horizon: int = 2048,
                        seed: int = 0, link_capacity: float = 8.0, **kw) -> Scenario:
    """Another job's on/off bursts injected onto half the links."""
    pairs = [(2 * f, 2 * f + 1) for f in range(flows)]
    topo = leaf_spine(2 * flows, n_spines, pairs, uplink_capacity=link_capacity, **kw)
    bg = _background_arrivals(_host(topo.capacity), horizon, load, burst_len, gap_len, seed)
    return topo, _schedule(np.ones((horizon, topo.links), np.float32), bg, kw.get("device"))


SCENARIOS: Dict[str, callable] = {
    "incast": incast,
    "oversubscription": oversubscription,
    "link_flap": link_flap,
    "straggler_worker": straggler_worker,
    "pfc_storm": pfc_storm,
    "crossjob_background": crossjob_background,
}

PAIR_SCENARIO_NAMES = ("incast", "oversubscription", "link_flap", "straggler_worker",
                       "pfc_storm", "crossjob_background")


def pair_scenarios(flows: int = 8, n_spines: int = 4, *, horizon: int = 2048,
                   link_capacity: float = 8.0, host_rate: float = 32.0,
                   oversub_ratio: float = 2.0, flap_period: int = 64,
                   flap_duty: float = 0.5, straggler_factor: float = 0.25,
                   storm_start: int = 16, storm_spread: int = 16,
                   storm_duration: int = 128, bg_load: float = 0.8, bg_burst: int = 32,
                   bg_gap: int = 32, bg_seed: int = 0, **kw) -> Dict[str, Scenario]:
    """The contention library on one uniform leaf-spine grid (2 * flows
    leaves, `n_spines` spines, F flows): every entry has the same shapes,
    so the family stacks (`stack_scenarios`)."""
    n_leaves = 2 * flows
    dev = kw.get("device")

    def grid(pairs, cap):
        return leaf_spine(n_leaves, n_spines, pairs, uplink_capacity=cap, **kw)

    disjoint = [(2 * f, 2 * f + 1) for f in range(flows)]
    fan_in = [(f + 1, 0) for f in range(flows)]
    ring = [(w, (w + 1) % flows) for w in range(flows)]
    topo = grid(disjoint, link_capacity)
    L = topo.links
    straggle = np.ones((1, L), np.float32)
    for s in range(n_spines):
        straggle[0, uplink_id(0, s, n_leaves, n_spines)] = straggler_factor
    zeros = np.zeros((horizon, L), np.float32)
    out: Dict[str, Scenario] = {
        "incast": (grid(fan_in, link_capacity), _null(topo)),
        "oversubscription": (grid(disjoint, host_rate / (oversub_ratio * n_spines)),
                             _null(topo)),
        "link_flap": (topo, _schedule(
            _flap_caps(n_leaves, n_spines, L, horizon, flap_period, flap_duty, 0),
            zeros, dev)),
        "straggler_worker": (grid(ring, link_capacity),
                             _schedule(straggle, np.zeros((1, L), np.float32), dev)),
        "pfc_storm": (topo, _schedule(
            _storm_caps(n_leaves, n_spines, L, horizon, storm_start, storm_spread,
                        storm_duration), zeros, dev)),
        "crossjob_background": (topo, _schedule(
            np.ones((horizon, L), np.float32),
            _background_arrivals(_host(topo.capacity), horizon, bg_load, bg_burst,
                                 bg_gap, bg_seed), dev)),
    }
    assert tuple(out) == PAIR_SCENARIO_NAMES
    return out


def _tensor_fields(obj):
    return [f.name for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)]


def stack_pytrees(trees: Sequence):
    """Stack the tensor fields of like dataclasses on a new leading axis;
    every other field must be equal across them (they are static)."""
    trees = list(trees)
    if not trees:
        raise ValueError("need at least one pytree to stack")
    first = trees[0]
    names = _tensor_fields(first)
    statics = {f.name for f in dataclasses.fields(first)} - set(names)
    for t in trees[1:]:
        if type(t) is not type(first) or _tensor_fields(t) != names:
            raise ValueError("pytrees of different structure do not stack")
        for name in statics:
            if getattr(t, name) != getattr(first, name):
                raise ValueError(f"static field {name} differs: {getattr(t, name)} vs "
                                 f"{getattr(first, name)}")
    return dataclasses.replace(first, **{
        name: torch.stack([getattr(t, name) for t in trees]) for name in names})


def stack_scenarios(scens: Sequence[Scenario]) -> Scenario:
    """Stack uniform-shaped scenarios on a new leading axis.  Schedules of
    different horizons are first extended to the longest by repeating
    their last row (the fabric reads row min(t, T-1), so this changes no
    tick)."""
    scens = list(scens)
    if not scens:
        raise ValueError("need at least one scenario to stack")
    topos = [t for t, _ in scens]
    scheds = [s for _, s in scens]
    statics = {(t.fb_delay, t.ring_len) for t in topos}
    if len(statics) != 1:
        raise ValueError(f"scenario statics differ: {statics}")
    shapes = {tuple(tuple(getattr(t, name).shape) for name in _tensor_fields(t))
              for t in topos}
    if len(shapes) != 1:
        raise ValueError(f"scenario topology shapes differ (not stackable): {shapes}")
    T = max(s.horizon for s in scheds)

    def extend(s: EventSchedule) -> EventSchedule:
        pad = T - s.horizon
        if pad == 0:
            return s

        def rep(x):
            return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])

        return EventSchedule(cap_scale=rep(s.cap_scale), bg_arrivals=rep(s.bg_arrivals))

    return stack_pytrees(topos), stack_pytrees([extend(s) for s in scheds])


FAT_TREE_SCENARIO_NAMES = ("inter_pod_uniform", "inter_pod_incast", "pod_oversubscription",
                           "core_link_flap")


def _core_flap_caps(grid: FatTreeGrid, horizon: int, period: int, duty: float,
                    plane: int) -> np.ndarray:
    """Capacity scales for core plane `plane` (every spine->core and
    core->spine link of spine `plane`) flapping on a duty cycle."""
    cap = np.ones((horizon, grid.links), np.float32)
    down = (np.arange(horizon) % period) < duty * period
    for pod in range(grid.n_pods):
        for j in range(grid.cores_per_spine):
            cap[down, grid.up_spine_core(pod, plane, j)] = 0.0
            cap[down, grid.down_core_spine(plane, j, pod)] = 0.0
    return cap


def fat_tree_scenarios(flows: int = 16, n_pods: int = 4, leaves_per_pod: int = 2,
                       spines_per_pod: int = 2, cores_per_spine: int = 2, *,
                       horizon: int = 2048, link_capacity: float = 8.0,
                       host_rate: float = 32.0, oversub_ratio: float = 2.0,
                       flap_period: int = 64, flap_duty: float = 0.5, flap_plane: int = 0,
                       **kw) -> Dict[str, Scenario]:
    """The inter-pod contention library on one fat-tree grid:
    ``inter_pod_uniform`` (leaf f -> the same leaf position one pod over),
    ``inter_pod_incast`` (every flow into leaf 0 from the other pods),
    ``pod_oversubscription`` (uniform, core tiers at 1/oversub_ratio of the
    host demand) and ``core_link_flap`` (core plane `flap_plane` on a duty
    cycle)."""
    grid = FatTreeGrid(n_pods, leaves_per_pod, spines_per_pod, cores_per_spine)
    n_leaves = grid.n_leaves
    if n_pods < 2:
        raise ValueError("inter-pod scenarios need >= 2 pods")
    dev = kw.get("device")

    def tree(pairs, **caps):
        return fat_tree(n_pods, leaves_per_pod, spines_per_pod, cores_per_spine, pairs,
                        uplink_capacity=link_capacity, **caps, **kw)

    uniform = [(f % n_leaves, (f + leaves_per_pod) % n_leaves) for f in range(flows)]
    others = [lf for lf in range(n_leaves) if lf >= leaves_per_pod]
    fan_in = [(others[f % len(others)], 0) for f in range(flows)]
    topo_u = tree(uniform)
    L = topo_u.links
    out: Dict[str, Scenario] = {
        "inter_pod_uniform": (topo_u, _null(topo_u)),
        "inter_pod_incast": (tree(fan_in), _null(topo_u)),
        "pod_oversubscription": (
            tree(uniform, core_capacity=host_rate
                 / (oversub_ratio * spines_per_pod * cores_per_spine)),
            _null(topo_u)),
        "core_link_flap": (topo_u, _schedule(
            _core_flap_caps(grid, horizon, flap_period, flap_duty, flap_plane),
            np.zeros((horizon, L), np.float32), dev)),
    }
    assert tuple(out) == FAT_TREE_SCENARIO_NAMES
    return out
