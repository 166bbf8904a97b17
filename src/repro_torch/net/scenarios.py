"""Scenario library for the shared fabric: topologies plus event schedules.

Each constructor returns ``(TopologyParams, EventSchedule)``, built on the
host with numpy exactly as the reference's (`repro.net.scenarios`) and
handed over as tensors (on ``device`` when it is given): the leaf-spine
constructors (`incast` ... `crossjob_background`, `two_path_whack`), the
uniform-grid pair family (`pair_scenarios`), the fat-tree family
(`fat_tree_scenarios`), stacking (`stack_pytrees`, `stack_scenarios`),
the job library (`job_scenarios`: the same contention patterns on a ring
of training workers), the cluster library (`cluster_scenarios`: J whole
jobs co-scheduled on one fabric, `repro_torch.net.cluster`) and the four
correlated-failure families (`correlated_*_scenarios`, built from the
processes of `repro_torch.net.failures`; `CORRELATED_SCENARIOS`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.net.cluster import Cluster, cluster_topology, place_jobs
from repro_torch.net.failures import (SRLGEvent, burst_flap_caps, cascade_caps, compose_caps,
                                      fat_tree_cascade_waves, fat_tree_srlgs, hawkes_times,
                                      leaf_spine_cascade_waves, leaf_spine_srlgs, srlg_caps)
from repro_torch.net.jobs import JobSchedule
from repro_torch.net.topology import (EventSchedule, FatTreeGrid, TopologyParams,
                                      downlink_id, fat_tree, leaf_spine, null_schedule,
                                      uplink_id)

__all__ = ["Scenario", "incast", "oversubscription", "link_flap", "straggler_worker",
           "pfc_storm", "crossjob_background", "two_path_whack", "SCENARIOS",
           "pair_scenarios", "PAIR_SCENARIO_NAMES", "stack_pytrees", "stack_scenarios",
           "fat_tree_scenarios", "FAT_TREE_SCENARIO_NAMES", "job_scenarios",
           "JOB_SCENARIO_NAMES", "ClusterScenario", "cluster_scenarios",
           "CLUSTER_SCENARIO_NAMES", "correlated_pair_scenarios",
           "CORRELATED_PAIR_SCENARIO_NAMES", "correlated_fat_tree_scenarios",
           "CORRELATED_FAT_TREE_SCENARIO_NAMES", "correlated_job_scenarios",
           "CORRELATED_JOB_SCENARIO_NAMES", "correlated_cluster_scenarios",
           "CORRELATED_CLUSTER_SCENARIO_NAMES", "CORRELATED_SCENARIOS"]

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


# --- job scenarios: the same contention patterns on a RING placement ------

JOB_SCENARIO_NAMES = ("uncontended", "oversubscribed", "link_flap", "straggler_worker",
                      "pfc_storm", "crossjob_background")


def job_scenarios(workers: int = 4, n_spines: int = 4, *, horizon: int = 2048,
                  link_capacity: float = 8.0, host_rate: float = 32.0,
                  oversub_ratio: float = 2.0, flap_period: int = 128,
                  flap_duty: float = 0.5, storm_start: int = 48, storm_spread: int = 32,
                  storm_duration: int = 384, bg_load: float = 0.6, bg_burst: int = 64,
                  bg_gap: int = 64, bg_seed: int = 0, **kw) -> Dict[str, Scenario]:
    """The contention library re-placed for a training job's ring
    collective: worker w on leaf w sends to leaf (w+1) % workers, so every
    entry shares ONE topology shape and differs only in its event schedule
    / capacities (`repro_torch.net.jobs` reads each schedule from a step's
    planned offset).  `uncontended` is the ETTR reference point."""
    pairs = [(w, (w + 1) % workers) for w in range(workers)]
    dev = kw.get("device")

    def ring(cap):
        return leaf_spine(workers, n_spines, pairs, uplink_capacity=cap, **kw)

    topo = ring(link_capacity)
    n_leaves, L = workers, topo.links
    zeros = np.zeros((horizon, L), np.float32)
    out: Dict[str, Scenario] = {
        "uncontended": (topo, _null(topo)),
        "oversubscribed": (ring(host_rate / (oversub_ratio * n_spines)), _null(topo)),
        "link_flap": (topo, _schedule(
            _flap_caps(n_leaves, n_spines, L, horizon, flap_period, flap_duty, 0),
            zeros, dev)),
        "straggler_worker": straggler_worker(workers, n_spines,
                                             link_capacity=link_capacity, **kw),
        "pfc_storm": (topo, _schedule(
            _storm_caps(n_leaves, n_spines, L, horizon, storm_start, storm_spread,
                        storm_duration), zeros, dev)),
        "crossjob_background": (topo, _schedule(
            np.ones((horizon, L), np.float32),
            _background_arrivals(_host(topo.capacity), horizon, bg_load, bg_burst, bg_gap,
                                 bg_seed), dev)),
    }
    assert tuple(out) == JOB_SCENARIO_NAMES
    return out


# --- cluster scenarios: J whole jobs co-scheduled on ONE fabric -----------

CLUSTER_SCENARIO_NAMES = ("uncontended", "rings_overlapped", "staggered_start",
                          "straggler_job_a", "flap_during_overlap", "oversubscribed")

ClusterScenario = Tuple[Cluster, TopologyParams, EventSchedule]


def cluster_scenarios(jobs: Sequence[JobSchedule], n_spines: int = 4, *,
                      horizon: int = 2048, link_capacity: float = 8.0,
                      host_rate: float = 32.0, oversub_ratio: float = 2.0,
                      stagger_steps: Optional[int] = None, straggler_factor: float = 0.25,
                      flap_period: int = 128, flap_duty: float = 0.5, flap_spine: int = 0,
                      **kw) -> Dict[str, ClusterScenario]:
    """Co-scheduled multi-job contention library for `repro_torch.net.cluster`:
    {name: (Cluster, TopologyParams, EventSchedule)} for every entry of
    `CLUSTER_SCENARIO_NAMES`:

      * uncontended        — disjoint leaf blocks (the jobs share no link);
      * rings_overlapped   — every job's worker w on leaf w: the jobs share
                             every link their rings touch;
      * staggered_start    — overlapped rings, job j starts j *
                             `stagger_steps` rounds late (default: half of
                             job 0's schedule);
      * straggler_job_a    — overlapped rings; job A's worker-0 uplinks at
                             `straggler_factor` of nominal;
      * flap_during_overlap— overlapped rings; spine `flap_spine` flaps on
                             a duty cycle while both jobs are live;
      * oversubscribed     — overlapped rings with the spine layer at
                             1/`oversub_ratio` of the aggregate host demand.

    Every placement is built on the largest placement's leaf grid, so the
    family shares one link-array shape and stacks.
    """
    jobs = list(jobs)
    dev = kw.get("device")
    if stagger_steps is None:
        stagger_steps = max(1, jobs[0].total_steps // 2)
    coloc = place_jobs(jobs, colocated=True)
    disjoint = place_jobs(jobs, colocated=False)
    staggered = place_jobs(jobs, colocated=True,
                           start_steps=[j * stagger_steps for j in range(len(jobs))])
    n_leaves = max(coloc.n_leaves, disjoint.n_leaves)
    topo_c = cluster_topology(coloc, n_spines, n_leaves=n_leaves,
                              uplink_capacity=link_capacity, **kw)
    topo_d = cluster_topology(disjoint, n_spines, n_leaves=n_leaves,
                              uplink_capacity=link_capacity, **kw)
    topo_o = cluster_topology(coloc, n_spines, n_leaves=n_leaves,
                              uplink_capacity=host_rate / (oversub_ratio * n_spines), **kw)
    L = topo_c.links

    straggle = np.ones((1, L), np.float32)
    leaf_a0 = coloc.jobs[0].leaves[0]
    for s in range(n_spines):
        straggle[0, uplink_id(leaf_a0, s, n_leaves, n_spines)] = straggler_factor

    out: Dict[str, ClusterScenario] = {
        "uncontended": (disjoint, topo_d, _null(topo_d)),
        "rings_overlapped": (coloc, topo_c, _null(topo_c)),
        "staggered_start": (staggered, topo_c, _null(topo_c)),
        "straggler_job_a": (coloc, topo_c,
                            _schedule(straggle, np.zeros((1, L), np.float32), dev)),
        "flap_during_overlap": (coloc, topo_c, _schedule(
            _flap_caps(n_leaves, n_spines, L, horizon, flap_period, flap_duty, flap_spine),
            np.zeros((horizon, L), np.float32), dev)),
        "oversubscribed": (coloc, topo_o, _null(topo_o)),
    }
    assert tuple(out) == CLUSTER_SCENARIO_NAMES
    return out


# --- correlated failure scenarios (repro_torch.net.failures) --------------
#
# The correlated processes (SRLG group events, hop-by-hop PFC cascades,
# Hawkes burst flaps) placed on the same uniform grids as the libraries
# above: one topology shape per family, schedules differ per entry.  Event
# timing is in fractions of `horizon` (onset at H/4, restore at H/2).
# Each of the pair and fat-tree families ends with a *blackout* entry that
# never restores and strands in-flight flows.

CORRELATED_PAIR_SCENARIO_NAMES = ("srlg_spine_down", "srlg_spine_derate",
                                  "srlg_double_fault", "pfc_cascade", "burst_flaps",
                                  "derate_cascade", "blackout")


def _flap_times(H: int, mu, branching: float, tau, seed: int) -> np.ndarray:
    """Hawkes burst-flap times on [H/4, 5H/8)."""
    return H // 4 + hawkes_times(
        H * 3 // 8, mu=mu if mu is not None else 4.0 / H, branching=branching,
        tau=tau if tau is not None else max(8.0, H / 64), seed=seed)


def correlated_pair_scenarios(flows: int = 8, n_spines: int = 4, *, horizon: int = 2048,
                              link_capacity: float = 8.0, derate_severity: float = 0.75,
                              cascade_hop_delay: Optional[int] = None,
                              cascade_decay: float = 0.6, flap_mu: Optional[float] = None,
                              flap_branching: float = 0.7, flap_tau: Optional[float] = None,
                              flap_len: Optional[int] = None, flap_seed: int = 0,
                              **kw) -> Dict[str, Scenario]:
    """Correlated failures on the uniform leaf-spine pair grid (disjoint
    pairs 2f -> 2f+1): spine 0's SRLG down over [H/4, H/2)
    (``srlg_spine_down``), spines 0 and 1 derated to ``1 -
    derate_severity`` (``srlg_spine_derate``), two staggered overlapping
    outages (``srlg_double_fault``), the upstream PFC cascade
    (``pfc_cascade``), Hawkes burst flaps on the spine SRLGs over [H/4,
    5H/8) (``burst_flaps``), spine 1 derated over [H/8, 5H/8) with the
    cascade inside it (``derate_cascade``) and every spine down from H/4
    with no restore (``blackout``)."""
    n_leaves = 2 * flows
    pairs = [(2 * f, 2 * f + 1) for f in range(flows)]
    dev = kw.get("device")
    topo = leaf_spine(n_leaves, n_spines, pairs, uplink_capacity=link_capacity, **kw)
    L, H = topo.links, horizon
    t_on, t_off = H // 4, H // 2
    groups = leaf_spine_srlgs(n_leaves, n_spines)
    spine0, spine1 = groups["spine0"], groups["spine1"]
    waves = leaf_spine_cascade_waves(n_leaves, n_spines)
    hop = cascade_hop_delay if cascade_hop_delay is not None else max(1, H // 128)
    f_len = flap_len if flap_len is not None else max(4, H // 64)
    times = _flap_times(H, flap_mu, flap_branching, flap_tau, flap_seed)
    zeros = np.zeros((H, L), np.float32)

    def sched(cap):
        return _schedule(cap, zeros, dev)

    cascade = cascade_caps(L, H, waves, start=t_on, duration=t_off - t_on, hop_delay=hop,
                           severity=1.0, decay=cascade_decay)
    out: Dict[str, Scenario] = {
        "srlg_spine_down": (topo, sched(srlg_caps(L, H, [SRLGEvent(spine0, t_on, t_off)]))),
        "srlg_spine_derate": (topo, sched(srlg_caps(L, H, [
            SRLGEvent(spine0, t_on, t_off, derate_severity),
            SRLGEvent(spine1, t_on, t_off, derate_severity)]))),
        "srlg_double_fault": (topo, sched(srlg_caps(L, H, [
            SRLGEvent(spine0, t_on, t_off), SRLGEvent(spine1, H * 3 // 8, H * 5 // 8)]))),
        "pfc_cascade": (topo, sched(cascade)),
        "burst_flaps": (topo, sched(burst_flap_caps(L, H, list(groups.values()), times,
                                                    flap_len=f_len, seed=flap_seed))),
        "derate_cascade": (topo, sched(compose_caps(
            srlg_caps(L, H, [SRLGEvent(spine1, H // 8, H * 5 // 8, derate_severity)]),
            cascade))),
        "blackout": (topo, sched(srlg_caps(L, H, [SRLGEvent(g, t_on, H)
                                                  for g in groups.values()]))),
    }
    assert tuple(out) == CORRELATED_PAIR_SCENARIO_NAMES
    return out


CORRELATED_FAT_TREE_SCENARIO_NAMES = ("srlg_pod_spine_down", "srlg_core_plane_down",
                                      "srlg_pod_isolated", "pfc_cascade", "burst_flaps",
                                      "plane_maintenance_cascade", "core_blackout")


def correlated_fat_tree_scenarios(flows: int = 16, n_pods: int = 4, leaves_per_pod: int = 2,
                                  spines_per_pod: int = 2, cores_per_spine: int = 2, *,
                                  horizon: int = 2048, link_capacity: float = 8.0,
                                  derate_severity: float = 0.75,
                                  cascade_hop_delay: Optional[int] = None,
                                  cascade_decay: float = 0.6,
                                  flap_mu: Optional[float] = None,
                                  flap_branching: float = 0.7,
                                  flap_tau: Optional[float] = None,
                                  flap_len: Optional[int] = None, flap_seed: int = 0,
                                  **kw) -> Dict[str, Scenario]:
    """Correlated failures on the 3-tier fat-tree grid (the uniform
    inter-pod placement of `fat_tree_scenarios`): pod 0 / spine 0's ASIC
    SRLG down over [H/4, H/2) (``srlg_pod_spine_down``), core plane 0's
    optics down (``srlg_core_plane_down``), pod 0's uplink bundle down
    (``srlg_pod_isolated``), the four-tier upstream PFC cascade
    (``pfc_cascade``), Hawkes burst flaps on the pod-spine SRLGs
    (``burst_flaps``), core plane 1 derated over [H/8, 5H/8) with the
    cascade inside it (``plane_maintenance_cascade``) and every core
    plane down from H/4 with no restore (``core_blackout``)."""
    grid = FatTreeGrid(n_pods, leaves_per_pod, spines_per_pod, cores_per_spine)
    if n_pods < 2:
        raise ValueError("correlated fat-tree scenarios need >= 2 pods")
    dev = kw.get("device")
    n_leaves = grid.n_leaves
    uniform = [(f % n_leaves, (f + leaves_per_pod) % n_leaves) for f in range(flows)]
    topo = fat_tree(n_pods, leaves_per_pod, spines_per_pod, cores_per_spine, uniform,
                    uplink_capacity=link_capacity, **kw)
    L, H = topo.links, horizon
    t_on, t_off = H // 4, H // 2
    srlgs = fat_tree_srlgs(grid)
    waves = fat_tree_cascade_waves(grid)
    hop = cascade_hop_delay if cascade_hop_delay is not None else max(1, H // 128)
    f_len = flap_len if flap_len is not None else max(4, H // 64)
    pod_spine_groups = [srlgs[f"pod{p}_spine{s}"]
                        for p in range(n_pods) for s in range(spines_per_pod)]
    times = _flap_times(H, flap_mu, flap_branching, flap_tau, flap_seed)
    zeros = np.zeros((H, L), np.float32)

    def sched(cap):
        return _schedule(cap, zeros, dev)

    cascade = cascade_caps(L, H, waves, start=t_on, duration=t_off - t_on, hop_delay=hop,
                           severity=1.0, decay=cascade_decay)
    out: Dict[str, Scenario] = {
        "srlg_pod_spine_down": (topo, sched(srlg_caps(
            L, H, [SRLGEvent(srlgs["pod0_spine0"], t_on, t_off)]))),
        "srlg_core_plane_down": (topo, sched(srlg_caps(
            L, H, [SRLGEvent(srlgs["core_plane0"], t_on, t_off)]))),
        "srlg_pod_isolated": (topo, sched(srlg_caps(
            L, H, [SRLGEvent(srlgs["pod0_uplinks"], t_on, t_off)]))),
        "pfc_cascade": (topo, sched(cascade)),
        "burst_flaps": (topo, sched(burst_flap_caps(L, H, pod_spine_groups, times,
                                                    flap_len=f_len, seed=flap_seed))),
        "plane_maintenance_cascade": (topo, sched(compose_caps(
            srlg_caps(L, H, [SRLGEvent(srlgs[f"core_plane{min(1, spines_per_pod - 1)}"],
                                       H // 8, H * 5 // 8, derate_severity)]),
            cascade))),
        "core_blackout": (topo, sched(srlg_caps(L, H, [
            SRLGEvent(srlgs[f"core_plane{s}"], t_on, H) for s in range(spines_per_pod)]))),
    }
    assert tuple(out) == CORRELATED_FAT_TREE_SCENARIO_NAMES
    return out


CORRELATED_JOB_SCENARIO_NAMES = ("srlg_spine_down", "pfc_cascade", "burst_flaps")


def _correlated_ring(topo, n_leaves, n_spines, H, cascade_hop_delay, cascade_decay,
                     flap_seed, dev):
    """The three correlated entries on a ring placement (job and cluster
    families): spine 0's SRLG down over [H/4, H/2), the PFC cascade rooted
    at leaf 1 % n_leaves, Hawkes burst flaps over the spine SRLGs."""
    L = topo.links
    t_on, t_off = H // 4, H // 2
    groups = leaf_spine_srlgs(n_leaves, n_spines)
    waves = leaf_spine_cascade_waves(n_leaves, n_spines, root_leaf=1 % n_leaves)
    hop = cascade_hop_delay if cascade_hop_delay is not None else max(1, H // 128)
    times = _flap_times(H, None, 0.7, None, flap_seed)
    zeros = np.zeros((H, L), np.float32)
    return {
        "srlg_spine_down": _schedule(
            srlg_caps(L, H, [SRLGEvent(groups["spine0"], t_on, t_off)]), zeros, dev),
        "pfc_cascade": _schedule(
            cascade_caps(L, H, waves, start=t_on, duration=t_off - t_on, hop_delay=hop,
                         severity=1.0, decay=cascade_decay), zeros, dev),
        "burst_flaps": _schedule(
            burst_flap_caps(L, H, list(groups.values()), times, flap_len=max(4, H // 64),
                            seed=flap_seed), zeros, dev),
    }


def correlated_job_scenarios(workers: int = 4, n_spines: int = 4, *, horizon: int = 2048,
                             link_capacity: float = 8.0,
                             cascade_hop_delay: Optional[int] = None,
                             cascade_decay: float = 0.6, flap_seed: int = 0,
                             **kw) -> Dict[str, Scenario]:
    """The correlated processes on a training job's ring (worker w ->
    worker (w+1) % workers), for `repro_torch.net.jobs`: one spine-ASIC
    SRLG outage [H/4, H/2), the upstream PFC cascade and Hawkes burst
    flaps over the spine SRLGs; every entry shares the ring topology."""
    pairs = [(w, (w + 1) % workers) for w in range(workers)]
    topo = leaf_spine(workers, n_spines, pairs, uplink_capacity=link_capacity, **kw)
    scheds = _correlated_ring(topo, workers, n_spines, horizon, cascade_hop_delay,
                              cascade_decay, flap_seed, kw.get("device"))
    out: Dict[str, Scenario] = {name: (topo, s) for name, s in scheds.items()}
    assert tuple(out) == CORRELATED_JOB_SCENARIO_NAMES
    return out


CORRELATED_CLUSTER_SCENARIO_NAMES = ("srlg_spine_down", "pfc_cascade", "burst_flaps")


def correlated_cluster_scenarios(jobs: Sequence[JobSchedule], n_spines: int = 4, *,
                                 horizon: int = 2048, link_capacity: float = 8.0,
                                 cascade_hop_delay: Optional[int] = None,
                                 cascade_decay: float = 0.6, flap_seed: int = 0,
                                 **kw) -> Dict[str, ClusterScenario]:
    """Correlated failures under co-scheduled jobs: the overlapped-rings
    placement of `cluster_scenarios` with a spine-ASIC SRLG outage, the PFC
    cascade and Hawkes burst flaps layered on top."""
    coloc = place_jobs(list(jobs), colocated=True)
    topo = cluster_topology(coloc, n_spines, n_leaves=coloc.n_leaves,
                            uplink_capacity=link_capacity, **kw)
    scheds = _correlated_ring(topo, coloc.n_leaves, n_spines, horizon, cascade_hop_delay,
                              cascade_decay, flap_seed, kw.get("device"))
    out: Dict[str, ClusterScenario] = {name: (coloc, topo, s) for name, s in scheds.items()}
    assert tuple(out) == CORRELATED_CLUSTER_SCENARIO_NAMES
    return out


# family name -> correlated library constructor
CORRELATED_SCENARIOS: Dict[str, callable] = {
    "pair": correlated_pair_scenarios,
    "fat_tree": correlated_fat_tree_scenarios,
    "job": correlated_job_scenarios,
    "cluster": correlated_cluster_scenarios,
}
