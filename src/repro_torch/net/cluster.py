"""Cluster layer: J co-scheduled training jobs contending on ONE fabric.

The port of the JAX package's `net/cluster.py`.  A single job run
(`repro_torch.net.jobs`) gives a job the whole leaf-spine topology to
itself; here the interference between jobs is EMERGENT: the competing
traffic is another job's actual collectives, not an injected trace.

  1. `place_jobs` maps J `JobSchedule`s (different models, worker counts,
     start offsets) onto the leaves of one shared topology: each job keeps
     its own ring (worker w -> worker (w+1) % W_j), on disjoint leaves (the
     uncontended reference) or co-located on the same leaves (jobs share
     every uplink and downlink).
  2. `cluster_round_table` aligns the jobs' step tables into global
     ROUNDS: round r runs step (r - start_j) of every job j active then.
     All active steps run as ONE coupled-flow simulation
     (`sender.run_flows_sized` with a per-flow size vector): a flow whose
     job is idle or not yet started gets size 0, completes at tick 0 and
     emits nothing.
  3. `run_cluster` / `sweep_cluster` run every round x (contended + per-job
     solo) size variant; the solo variants (every other job's flows
     silenced to size 0) run with the same key, ``fold_in(key, r)``, so
     cross-job slowdown is a paired comparison.  Rounds, variants,
     policies, draws and scenarios run one after another: every slice is
     bit for bit the unbatched run, and outputs carry the reference's axes
     (round axis at -2: ``cct[..., V, R, F]``, ``link_served[..., V, R, L]``).

Metrics beyond per-job ETTR (`jobs.job_ettr` applied per job), host
float64 numpy as in the reference:

  * slowdown      — (compute + exposed comm, contended) / (same, solo).
  * Jain fairness — (sum x)^2 / (J * sum x^2) over x_j = 1/slowdown_j.
  * link utilization — per-link served packets over nominal capacity x
                    busy ticks, from the fabric's conservation counters.

Rounds are a bulk-synchronous alignment anchored to job 0's planned
timeline, extended at its trailing cadence past its end.  The
flow-sharded runners (`shard_run_cluster_rounds`,
`shard_sweep_cluster_rounds`, `sweep_cluster(mesh=)`) split each round's
flows over the ranks of a `sender.flow_mesh` and give the unsharded
results bit for bit.  Entry points run on the card by default.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.device import resolve_device
from repro_torch.net.jobs import JobSchedule, job_ettr, scheduled_events, step_table
from repro_torch.net.sender import (Mesh, SenderParams, SenderSpec, _keys, _points,
                                    _run_flows, _shard_runs, _stack_runs, flow_mesh,
                                    to_device)
from repro_torch.net.telemetry import _np, frame_select
from repro_torch.net.topology import EventSchedule, TopologyParams, fat_tree, leaf_spine

__all__ = [
    "ClusterJob",
    "Cluster",
    "ClusterResult",
    "place_jobs",
    "place_jobs_pods",
    "cluster_topology",
    "cluster_fat_tree_topology",
    "cluster_round_table",
    "solo_size_variants",
    "cluster_inputs",
    "run_cluster_rounds",
    "sweep_cluster_rounds",
    "sweep_cluster_rounds_scenarios",
    "shard_run_cluster_rounds",
    "shard_sweep_cluster_rounds",
    "jain_index",
    "link_utilization",
    "cluster_metrics",
    "run_cluster",
    "sweep_cluster",
]


@dataclasses.dataclass(frozen=True)
class ClusterJob:
    """One job's placement on the shared fabric (static, host-side)."""

    job: JobSchedule
    start_step: int           # global round in which the job's step 0 runs
    leaves: Tuple[int, ...]   # leaf hosting each worker (len == job.workers)

    def __post_init__(self):
        if len(self.leaves) != self.job.workers:
            raise ValueError(
                f"{self.job.arch}: {len(self.leaves)} leaves for "
                f"{self.job.workers} workers"
            )
        if self.start_step < 0:
            raise ValueError(f"start_step must be >= 0, got {self.start_step}")


@dataclasses.dataclass(frozen=True)
class Cluster:
    """J placed jobs sharing one leaf-spine fabric."""

    jobs: Tuple[ClusterJob, ...]
    n_leaves: int

    @property
    def flows(self) -> int:
        """Total coupled flows: one per (job, worker)."""
        return sum(cj.job.workers for cj in self.jobs)

    @property
    def rounds(self) -> int:
        """Global rounds R = max over jobs of start_step + total_steps."""
        return max(cj.start_step + cj.job.total_steps for cj in self.jobs)

    @property
    def flow_job(self) -> np.ndarray:
        """int32[F] owning job index of each flow (jobs' flows contiguous)."""
        return np.concatenate(
            [
                np.full(cj.job.workers, j, np.int32)
                for j, cj in enumerate(self.jobs)
            ]
        )

    def flow_pairs(self) -> np.ndarray:
        """int32[F, 2] (src_leaf, dst_leaf): each job's own ring."""
        pairs = []
        for cj in self.jobs:
            W = cj.job.workers
            for w in range(W):
                pairs.append((cj.leaves[w], cj.leaves[(w + 1) % W]))
        return np.asarray(pairs, np.int32)

    def job_flows(self, j: int) -> slice:
        """Flow-axis slice owned by job j."""
        lo = sum(cj.job.workers for cj in self.jobs[:j])
        return slice(lo, lo + self.jobs[j].job.workers)


def _starts(jobs, start_steps):
    if not jobs:
        raise ValueError("need at least one job")
    if any(j.workers < 2 for j in jobs):
        raise ValueError("every job needs >= 2 workers to form a ring")
    starts = tuple(start_steps) if start_steps is not None else (0,) * len(jobs)
    if len(starts) != len(jobs):
        raise ValueError(f"{len(starts)} start_steps for {len(jobs)} jobs")
    if starts[0] != 0:
        raise ValueError(
            "job 0 anchors the planned timeline: start_steps[0] must be 0"
        )
    return starts


def place_jobs(
    jobs: Sequence[JobSchedule],
    *,
    colocated: bool = True,
    start_steps: Optional[Sequence[int]] = None,
) -> Cluster:
    """Place J jobs' rings on one fabric.

    `colocated=True` puts every job's worker w on leaf w: jobs share the
    per-leaf uplinks and downlinks, the contended multi-tenant regime.
    `colocated=False` gives each job its own disjoint block of leaves:
    with a 2-tier leaf-spine there is then NO shared link, which makes it
    the emergence-free reference placement ("uncontended").

    Job 0 anchors the global planned timeline, so `start_steps[0]` must be
    0 (stagger the others relative to it).
    """
    starts = _starts(jobs, start_steps)
    placed, base = [], 0
    for job, start in zip(jobs, starts):
        if colocated:
            leaves = tuple(range(job.workers))
        else:
            leaves = tuple(range(base, base + job.workers))
            base += job.workers
        placed.append(ClusterJob(job=job, start_step=int(start), leaves=leaves))
    n_leaves = 1 + max(max(cj.leaves) for cj in placed)
    return Cluster(jobs=tuple(placed), n_leaves=n_leaves)


def cluster_topology(
    cluster: Cluster,
    n_spines: int = 4,
    *,
    n_leaves: Optional[int] = None,
    **leaf_spine_kwargs,
) -> TopologyParams:
    """The shared leaf-spine fabric under a placed cluster: F = sum(W_j)
    coupled flows, each job riding its own ring over the common links.

    `n_leaves` may over-provision the grid beyond the placement's own leaf
    count so that different placements (e.g. co-located vs disjoint) share
    one link-array shape and stack (`scenarios.stack_scenarios`); the
    extra leaves' links idle and change nothing.
    """
    return leaf_spine(
        max(cluster.n_leaves, n_leaves or 0),
        n_spines,
        cluster.flow_pairs(),
        **leaf_spine_kwargs,
    )


def place_jobs_pods(
    jobs: Sequence[JobSchedule],
    leaves_per_pod: int,
    *,
    start_steps: Optional[Sequence[int]] = None,
    pack: bool = False,
) -> Cluster:
    """Pod-aligned placement for 3-tier fat-tree fabrics.

    Each job's leaf block starts at a POD boundary: a job whose worker
    count fits `leaves_per_pod` forms an intra-pod ring (its traffic turns
    around at the pod spines and never crosses the core), a larger job
    spans consecutive pods and its ring wraps through the core layer.

    `pack=True` co-locates instead: every job's worker w rides leaf w (the
    multi-tenant regime of `place_jobs(colocated=True)`, here confined to
    the first ceil(max workers / leaves_per_pod) pods).
    """
    if leaves_per_pod < 1:
        raise ValueError("leaves_per_pod must be >= 1")
    starts = _starts(jobs, start_steps)
    placed, base = [], 0
    for job, start in zip(jobs, starts):
        if pack:
            leaves = tuple(range(job.workers))
        else:
            leaves = tuple(range(base, base + job.workers))
            # the next job starts at the next pod boundary
            base = -(-(base + job.workers) // leaves_per_pod) * leaves_per_pod
        placed.append(ClusterJob(job=job, start_step=int(start), leaves=leaves))
    # round the grid itself up to whole pods
    n_leaves = 1 + max(max(cj.leaves) for cj in placed)
    n_leaves = -(-n_leaves // leaves_per_pod) * leaves_per_pod
    return Cluster(jobs=tuple(placed), n_leaves=n_leaves)


def cluster_fat_tree_topology(
    cluster: Cluster,
    leaves_per_pod: int,
    spines_per_pod: int = 2,
    cores_per_spine: int = 2,
    *,
    n_pods: Optional[int] = None,
    **fat_tree_kwargs,
) -> TopologyParams:
    """The 3-tier fat-tree fabric under a placed cluster (the fat-tree
    counterpart of `cluster_topology`): F = sum(W_j) coupled flows with
    n = spines_per_pod * cores_per_spine paths each.  `n_pods` may
    over-provision beyond the placement's own pod count (idle pods change
    nothing)."""
    need_pods = -(-cluster.n_leaves // leaves_per_pod)
    return fat_tree(
        max(need_pods, n_pods or 0),
        leaves_per_pod,
        spines_per_pod,
        cores_per_spine,
        cluster.flow_pairs(),
        **fat_tree_kwargs,
    )


def cluster_round_table(
    cluster: Cluster,
) -> Tuple[np.ndarray, np.ndarray]:
    """Align the jobs' step tables into global rounds (host, static).

    Returns ``(sizes[R, F], offsets[R])``: sizes[r, f] is flow f's message
    for round r (its job's shard for step (r - start_j), or 0 when the job
    is not active) and offsets[r] the round's planned start tick on the
    global timeline (job 0's planned offsets, extended past its last step
    at its trailing cadence), where scenario event schedules are read from.
    """
    R, F = cluster.rounds, cluster.flows
    sizes = np.zeros((R, F), np.int32)
    tables = [step_table(cj.job) for cj in cluster.jobs]
    for j, (cj, (shard, _, _)) in enumerate(zip(cluster.jobs, tables)):
        sl = cluster.job_flows(j)
        lo, hi = cj.start_step, cj.start_step + len(shard)
        sizes[lo:hi, sl] = shard[:, None]
    base = tables[0][2].astype(np.float64)  # job 0's planned offsets
    if R > len(base):
        cadence = base[-1] - base[-2] if len(base) > 1 else 1.0
        cadence = max(cadence, 1.0)
        extra = base[-1] + cadence * np.arange(1, R - len(base) + 1)
        base = np.concatenate([base, extra])
    offsets = np.asarray(np.round(base[:R]), np.int64)
    return sizes, offsets


def solo_size_variants(cluster: Cluster, sizes: np.ndarray) -> np.ndarray:
    """Stack the contended run with J solo variants: ``[1 + J, R, F]``.

    Variant 0 is the full cluster; variant 1 + j silences every flow NOT
    owned by job j (size 0: completes at tick 0, emits nothing), so the
    solo baseline runs on the identical fabric, events and PRNG stream.
    """
    variants = [sizes]
    flow_job = cluster.flow_job
    for j in range(len(cluster.jobs)):
        v = sizes.copy()
        v[:, flow_job != j] = 0
        variants.append(v)
    return np.stack(variants)


def cluster_inputs(
    cluster: Cluster,
    sched: EventSchedule,
    horizon: int,
    rounds: Optional[int] = None,
    *,
    device=None,
) -> Tuple[EventSchedule, torch.Tensor]:
    """Runner inputs: per-round event schedules re-based at each round's
    planned offset ([R, horizon, L]), plus the int32 [1 + J, R, F] size
    variants, both on `device` (default: where `sched` lies).

    `rounds` pads the round axis up to a common length with all-silent
    rounds (every flow size 0), so clusters with different round counts
    share one shape on a stacked scenario axis.  Padded rounds read events
    past the planned timeline at job 0's trailing cadence and are never
    consulted by `cluster_metrics`.
    """
    sizes, offsets = cluster_round_table(cluster)
    if rounds is not None:
        if rounds < cluster.rounds:
            raise ValueError(
                f"rounds={rounds} < the cluster's {cluster.rounds} rounds"
            )
        pad = rounds - cluster.rounds
        if pad:
            sizes = np.concatenate(
                [sizes, np.zeros((pad, cluster.flows), np.int32)]
            )
            cadence = (
                max(float(offsets[-1] - offsets[-2]), 1.0)
                if len(offsets) > 1 else 1.0
            )
            extra = offsets[-1] + np.round(
                cadence * np.arange(1, pad + 1)
            ).astype(offsets.dtype)
            offsets = np.concatenate([offsets, extra])
    scheds = scheduled_events(sched, offsets, horizon, device=device)
    return scheds, torch.as_tensor(solo_size_variants(cluster, sizes),
                                   device=scheds.cap_scale.device)


_RAW = ("cct", "finished", "link_served", "link_busy")


def _round_runs(run, scheds, sizes, key, on_run, lead):
    """Every round x variant of one cluster run (see `run_cluster_rounds`),
    as ``run(sched, n_packets, key)`` outputs in that row-major order."""
    R = int(sizes.shape[-2])
    var = tuple(sizes.shape[:-2])
    keys = prng.fold_in(key, torch.arange(R, dtype=torch.int64, device=key.device))
    runs = []
    for r in range(R):
        sched_r = frame_select(scheds, r)
        for v in np.ndindex(*var):
            out = run(sched_r, sizes[v + (r,)], keys[r])
            if on_run is not None:
                on_run(lead + (r,) + v, out)
            runs.append(out)
    return runs


def _round_fields(runs, sizes, spec):
    """The raw fields of one cluster run's outputs, round axis at -2."""
    lead = (int(sizes.shape[-2]),) + tuple(sizes.shape[:-2])
    if spec.telemetry is not None:
        results, frame = _stack_runs(runs, lead)
    else:
        results, frame = _stack_runs(runs, lead), None
    res = {k: getattr(results, k).movedim(0, -2) for k in _RAW}
    if frame is not None:
        res["telemetry"] = frame
    return res


def _rounds(topo, scheds, spec, sp, sizes, key, horizon, dev, on_run, lead):
    def run(sched, n_packets, k):
        return _run_flows(topo, sched, spec, sp, n_packets, k, horizon, dev, False)

    return _round_fields(_round_runs(run, scheds, sizes, key.to(dev), on_run, lead), sizes,
                         spec)


def run_cluster_rounds(
    topo: TopologyParams,
    scheds: EventSchedule,
    spec: SenderSpec,
    sp: SenderParams,
    sizes: torch.Tensor,
    key: torch.Tensor,
    horizon: int = 2048,
    *,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Every round x size-variant of the cluster.

    `scheds` carries a leading round axis R (from `cluster_inputs`),
    `sizes[..., R, F]` the per-flow messages (any leading variant axes).
    Round r folds r into `key`, the SAME stream for every variant, so
    contended-vs-solo differences are contention, not noise.  Returns
    ``{"cct": [..., R, F], "finished": [..., R, F], "link_served": [..., R,
    L], "link_busy": [..., R, L]}``.  Each round and variant runs on its
    own with the engine's early exit, so a silent round (size 0
    everywhere) costs one chunk.

    With `spec.telemetry` set, a "telemetry" key carries the frame; unlike
    the metric tensors (round axis at -2), its leaves keep the ROUND axis
    leading, then the variant axes: ``telemetry.frame_select(frame, (r,
    v))`` reads round r of variant v.
    """
    dev = resolve_device(device)
    topo, scheds = to_device(topo, dev), to_device(scheds, dev)
    return _rounds(topo, scheds, spec, sp, torch.as_tensor(sizes).to(dev),
                   torch.as_tensor(key).to(dev), horizon, dev, None, ())


def _stack_dicts(outs, lead):
    res = {k: torch.stack([o[k] for o in outs]).reshape(lead + tuple(outs[0][k].shape))
           for k in _RAW}
    if "telemetry" in outs[0]:
        res["telemetry"] = _stack_runs([o["telemetry"] for o in outs], lead)
    return res


def _sweep_rounds(topo, scheds, spec, points, sizes, keys, horizon, dev, on_run, lead):
    outs = [_rounds(topo, scheds, spec, point, sizes, keys[d], horizon, dev, on_run,
                    lead + (p, d))
            for p, point in enumerate(points) for d in range(keys.shape[0])]
    return _stack_dicts(outs, (len(points), int(keys.shape[0])))


def sweep_cluster_rounds(
    topo: TopologyParams,
    scheds: EventSchedule,
    spec: SenderSpec,
    sp: SenderParams,
    sizes: torch.Tensor,
    keys: torch.Tensor,
    horizon: int = 2048,
    *,
    device="cuda",
    on_run: Callable | None = None,
) -> Dict[str, torch.Tensor]:
    """The cluster sweep: policies x draws x variants x rounds.

    `sp` carries a leading policy/config axis P, `keys` is [D, 2] PRNG
    draws, `sizes` is [V, R, F] (from `cluster_inputs`: V = 1 + J).
    Returns ``{"cct": [P, D, V, R, F], "finished": ..., "link_served": [P,
    D, V, R, L], "link_busy": ...}``; ``on_run((p, d, r, v), out)`` sees
    each run."""
    points, dev = _points(sp), resolve_device(device)
    topo, scheds = to_device(topo, dev), to_device(scheds, dev)
    return _sweep_rounds(topo, scheds, spec, points, torch.as_tensor(sizes).to(dev),
                         _keys(keys, dev), horizon, dev, on_run, ())


def sweep_cluster_rounds_scenarios(
    topos: TopologyParams,
    scheds: EventSchedule,
    spec: SenderSpec,
    sp: SenderParams,
    sizes: torch.Tensor,
    keys: torch.Tensor,
    horizon: int = 2048,
    *,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """`sweep_cluster_rounds` with a leading SCENARIO axis C everywhere.

    `topos` / `scheds` / `sizes` carry stacked per-scenario tensors (pad
    round counts with ``cluster_inputs(..., rounds=R_max)`` and build
    placements on a common leaf grid): ``{"cct": [C, P, D, V, R, F],
    ...}``.  Scenario c computes exactly what ``sweep_cluster_rounds(
    topos[c], scheds[c], ..., sizes[c], ...)`` would."""
    points, dev = _points(sp), resolve_device(device)
    C = int(topos.route.shape[0])
    if scheds.cap_scale.dim() != 4 or int(scheds.cap_scale.shape[0]) != C:
        raise ValueError(f"{C} topologies need {C} stacked [R, horizon, L] schedules, "
                         f"got {tuple(scheds.cap_scale.shape)}")
    sizes, keys = torch.as_tensor(sizes).to(dev), _keys(keys, dev)
    outs = [_sweep_rounds(to_device(frame_select(topos, c), dev),
                          to_device(frame_select(scheds, c), dev), spec, points, sizes[c],
                          keys, horizon, dev, None, (c,))
            for c in range(C)]
    return _stack_dicts(outs, (C,))


def shard_run_cluster_rounds(
    topo: TopologyParams,
    scheds: EventSchedule,
    spec: SenderSpec,
    sp: SenderParams,
    sizes: torch.Tensor,
    key: torch.Tensor,
    horizon: int = 2048,
    *,
    mesh: Mesh | None = None,
) -> Dict[str, torch.Tensor]:
    """`run_cluster_rounds` with the cluster's flow axis sharded over
    ``mesh`` (`sender.flow_mesh`; default: every visible card):
    bit-identical ``{"cct": [..., R, F], ...}``, each round's coupled run
    split across the ranks (flow counts the ranks do not divide are padded
    with silent flows and cut back off).  Telemetry is not supported on
    this path."""
    mesh = flow_mesh() if mesh is None else mesh
    sizes = torch.as_tensor(sizes)
    runs = _shard_runs(mesh, [topo], spec, horizon, lambda run, d: _round_runs(
        lambda sched, n, k: run(0, sched, sp, n, k), *d, None, ()),
        (scheds, sizes, torch.as_tensor(key)))
    return _round_fields(runs, sizes, spec)


def shard_sweep_cluster_rounds(
    topo: TopologyParams,
    scheds: EventSchedule,
    spec: SenderSpec,
    sp: SenderParams,
    sizes: torch.Tensor,
    keys: torch.Tensor,
    horizon: int = 2048,
    *,
    mesh: Mesh | None = None,
) -> Dict[str, torch.Tensor]:
    """`sweep_cluster_rounds` sharded over the flow axis: bit-identical
    ``{"cct": [P, D, V, R, F], ...}``, the policies and draws run one after
    another inside every rank."""
    mesh = flow_mesh() if mesh is None else mesh
    points, keys, sizes = _points(sp), _keys(keys, "cpu"), torch.as_tensor(sizes)
    pairs = [(point, d) for point in points for d in range(keys.shape[0])]

    def loop(run, data):
        scheds, sizes, keys = data
        return [out for point, d in pairs for out in _round_runs(
            lambda sched, n, k: run(0, sched, point, n, k), scheds, sizes, keys[d], None, ())]

    runs = _shard_runs(mesh, [topo], spec, horizon, loop, (scheds, sizes, keys))
    per = len(runs) // len(pairs)
    outs = [_round_fields(runs[i:i + per], sizes, spec) for i in range(0, len(runs), per)]
    return _stack_dicts(outs, (len(points), int(keys.shape[0])))


def jain_index(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Jain's fairness index (sum x)^2 / (J * sum x^2) along `axis`: 1.0
    when every job gets an equal share, -> 1/J under total capture."""
    x = np.asarray(x, np.float64)
    num = x.sum(axis=axis) ** 2
    den = x.shape[axis] * (x**2).sum(axis=axis)
    return num / np.maximum(den, 1e-12)


def link_utilization(
    topo: TopologyParams, link_served: np.ndarray, link_busy: np.ndarray
) -> np.ndarray:
    """Per-link utilization over the whole cluster run.

    ``link_served[..., R, L]`` / ``link_busy[..., R, L]`` are the fabric's
    cumulative served-packets and busy-ticks counters per round.
    Utilization = served / (nominal capacity x busy ticks): 1.0 is a link
    serving at line rate whenever it serves at all; events that scale
    capacity below nominal read as reduced utilization.  Links that never
    serve report 0.
    """
    served = np.asarray(_np(link_served), np.float64).sum(axis=-2)   # [..., L]
    busy = np.asarray(_np(link_busy), np.float64).sum(axis=-2)       # [..., L]
    cap = np.asarray(_np(topo.capacity), np.float64)                 # [L]
    return served / np.maximum(cap * busy, 1e-9)


@dataclasses.dataclass(frozen=True)
class ClusterResult:
    """Host-side result of one cluster run (see `cluster_metrics`)."""

    cluster: Cluster
    step_cct: Tuple[np.ndarray, ...]   # per job: [..., S_j] contended barriers
    ettr: np.ndarray                   # [..., J] contended per-job ETTR
    solo_ettr: np.ndarray              # [..., J] same fabric, job alone
    slowdown: np.ndarray               # [..., J] contended time / solo time
    jain: np.ndarray                   # [...] fairness over 1/slowdown
    link_util: np.ndarray              # [..., L] contended-run utilization
    finished: np.ndarray               # bool [...] all variants/rounds done


def cluster_metrics(
    cluster: Cluster,
    topo: TopologyParams,
    raw: Dict[str, torch.Tensor],
) -> ClusterResult:
    """Fold the raw ``[..., V, R, F]`` sweep output into per-job metrics.

    Per job j: its contended step barriers come from variant 0's rounds
    [start_j, start_j + S_j) maxed over its own flows, its solo barriers
    from variant 1 + j; `jobs.job_ettr` turns both into (ETTR, exposed).
    slowdown_j = (compute + exposed contended) / (compute + exposed solo),
    Jain fairness over x_j = 1 / slowdown_j, and link utilization from the
    contended variant's conservation counters.
    """
    cct = np.asarray(_np(raw["cct"]), np.float64)          # [..., V, R, F]
    finished = np.asarray(_np(raw["finished"]), bool)      # [..., V, R, F]
    link_served = _np(raw["link_served"])                  # [..., V, R, L]
    link_busy = _np(raw["link_busy"])                      # [..., V, R, L]
    lead = cct.shape[:-3]

    step_cct, ettrs, solos, slowdowns = [], [], [], []
    for j, cj in enumerate(cluster.jobs):
        S = cj.job.total_steps
        rounds = slice(cj.start_step, cj.start_step + S)
        fl = cluster.job_flows(j)
        barrier = cct[..., 0, rounds, fl].max(axis=-1)        # [..., S]
        barrier_solo = cct[..., 1 + j, rounds, fl].max(axis=-1)
        e, exp = job_ettr(cj.job, barrier)
        e_solo, exp_solo = job_ettr(cj.job, barrier_solo)
        compute = cj.job.compute_ticks * cj.job.iterations
        step_cct.append(barrier)
        ettrs.append(e)
        solos.append(e_solo)
        slowdowns.append((compute + exp) / (compute + exp_solo))
    ettr = np.stack(ettrs, axis=-1)                   # [..., J]
    solo = np.stack(solos, axis=-1)
    slowdown = np.stack(slowdowns, axis=-1)
    jain = jain_index(1.0 / np.maximum(slowdown, 1e-9), axis=-1)
    util = link_utilization(
        topo, link_served[..., 0, :, :], link_busy[..., 0, :, :]
    )
    return ClusterResult(
        cluster=cluster,
        step_cct=tuple(step_cct),
        ettr=ettr,
        solo_ettr=solo,
        slowdown=slowdown,
        jain=jain,
        link_util=util,
        finished=finished.reshape(lead + (-1,)).all(axis=-1),
    )


def _check_flows(topo: TopologyParams, cluster: Cluster) -> None:
    if topo.flows != cluster.flows:
        raise ValueError(
            f"topology has {topo.flows} flows but the cluster places "
            f"{cluster.flows}"
        )


def run_cluster(
    topo: TopologyParams,
    sched: EventSchedule,
    spec: SenderSpec,
    sp: SenderParams,
    cluster: Cluster,
    key: torch.Tensor,
    horizon: int = 2048,
    *,
    device="cuda",
) -> ClusterResult:
    """Run the whole cluster under one scenario with scalar sender params."""
    _check_flows(topo, cluster)
    dev = resolve_device(device)
    scheds, sizes = cluster_inputs(cluster, sched, horizon, device=dev)
    raw = run_cluster_rounds(topo, scheds, spec, sp, sizes, key, horizon, device=dev)
    return cluster_metrics(cluster, topo, raw)


def sweep_cluster(
    topo: TopologyParams,
    sched: EventSchedule,
    spec: SenderSpec,
    sp: SenderParams,
    cluster: Cluster,
    keys: torch.Tensor,
    horizon: int = 2048,
    *,
    mesh=None,
    device="cuda",
    on_run: Callable | None = None,
) -> ClusterResult:
    """Host convenience over `sweep_cluster_rounds`: P policies x D draws.
    Metric fields carry leading [P, D] axes (``ettr[P, D, J]``,
    ``jain[P, D]``, ``link_util[P, D, L]``, ...); ``on_run((p, d, r, v),
    out)`` sees each run.

    With ``mesh`` (a `sender.flow_mesh`) the raw sweep runs flow-sharded on
    the mesh's devices through `shard_sweep_cluster_rounds` (``device`` and
    ``on_run`` are not read): bit-identical raw outputs, so every derived
    metric is too."""
    _check_flows(topo, cluster)
    if mesh is not None:
        scheds, sizes = cluster_inputs(cluster, sched, horizon, device=mesh.devices[0])
        raw = shard_sweep_cluster_rounds(topo, scheds, spec, sp, sizes, keys, horizon,
                                         mesh=mesh)
    else:
        dev = resolve_device(device)
        scheds, sizes = cluster_inputs(cluster, sched, horizon, device=dev)
        raw = sweep_cluster_rounds(topo, scheds, spec, sp, sizes, keys, horizon, device=dev,
                                   on_run=on_run)
    return cluster_metrics(cluster, topo, raw)
