"""Job-level schedule compiler and runner: training steps as collective
schedules on the shared fabric (the paper's §1 ETTR claim at job scope).

The port of the JAX package's `net/jobs.py`.  The paper's headline metric
is the job-level effective training time ratio: how much of a training
job's wall clock is compute, not communication exposed by stragglers,
flaps and contention.

  1. `compile_job` turns a model config (`repro_torch.configs`) plus a
     DP x TP layout into a `JobSchedule`: per iteration, a compute window
     (ticks, from `analysis.costs.job_comm_terms`) and a sequence of ring
     collectives (allreduce of the bf16 gradients, allgather of the
     updated parameter shards), each sized from the arch's real byte
     counts and mapped into simulator packets.  Host float64 numpy, the
     reference's arithmetic line for line, so schedules are equal.
  2. `run_job` / `sweep_job` run every ring step of every phase of every
     iteration on the shared leaf-spine fabric through the sender engine
     (`sender.run_flows_sized`): step s runs with ``fold_in(key, s)``.
     The policy, draw, model and scenario axes run one after another, as
     the sender's sweeps do, so every slice is bit for bit the unbatched
     run; outputs carry the reference's axes ``[P, D, M, S]`` and
     ``[C, P, D, M, S]``.
  3. `job_ettr` folds the step barriers back into the job metric:

         ETTR = compute_ticks / (compute_ticks + exposed_comm_ticks)

     where a phase's exposed communication is max(0, CCT - overlap window).

Scenario composition: a scenario's event schedule is read from each
step's offset on the job's planned timeline (`scheduled_events`), built
once on the host with numpy and moved to the device once per scenario;
each step reads a view of it.

The flow-sharded runners (`shard_run_job_steps`, `shard_sweep_job_steps`,
`sweep_job(mesh=)`) split each step's ring flows over the ranks of a
`sender.flow_mesh` (threads with private process groups) and give the
unsharded results bit for bit.

Entry points run on the card by default (``device="cuda"``) and raise
when there is none; pass ``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.analysis.costs import job_comm_terms
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.net.sender import (Mesh, SenderParams, SenderSpec, _keys, _points,
                                    _run_flows, _shard_runs, _stack_runs, flow_mesh,
                                    to_device)
from repro_torch.net.telemetry import _np, frame_select
from repro_torch.net.topology import EventSchedule, TopologyParams

__all__ = [
    "JobPhase",
    "JobSchedule",
    "JobResult",
    "DEFAULT_OVERLAP",
    "compile_job",
    "step_table",
    "total_packets",
    "scheduled_events",
    "job_step_inputs",
    "run_job_steps",
    "sweep_job_steps",
    "sweep_job_steps_scenarios",
    "shard_run_job_steps",
    "shard_sweep_job_steps",
    "run_job",
    "sweep_job",
    "job_ettr",
]

# default per-phase overlap budget, as a fraction of the compute window:
# the gradient allreduce hides under the backward pass, the parameter
# allgather under (the start of) the next forward.
DEFAULT_OVERLAP = {"allreduce": 0.5, "allgather": 0.25}


@dataclasses.dataclass(frozen=True)
class JobPhase:
    """One collective phase of a training iteration (static, host-side)."""

    kind: str                # "allreduce" | "allgather"
    shard_packets: int       # simulator packets per ring step per worker
    ring_steps: int          # 2(W-1) for allreduce, W-1 for allgather
    overlap_ticks: float     # compute window this phase can hide under
    ideal_step_ticks: float  # fluid lower bound for one step (planning)

    @property
    def payload_packets(self) -> int:
        """Per-worker payload of the whole phase (all ring steps)."""
        return self.ring_steps * self.shard_packets


@dataclasses.dataclass(frozen=True)
class JobSchedule:
    """A compiled training job: iterations of compute + collective phases."""

    arch: str
    workers: int             # DP degree == ring flows on the fabric
    iterations: int
    compute_ticks: float     # per-iteration compute window (fabric ticks)
    tick_seconds: float      # calibration: seconds of real time per tick
    compute_comm_ratio: float
    phases: Tuple[JobPhase, ...]

    @property
    def steps_per_iteration(self) -> int:
        return sum(p.ring_steps for p in self.phases)

    @property
    def total_steps(self) -> int:
        return self.iterations * self.steps_per_iteration

    @property
    def ideal_comm_ticks(self) -> float:
        """Per-iteration fluid lower bound on total collective time."""
        return sum(p.ring_steps * p.ideal_step_ticks for p in self.phases)


@dataclasses.dataclass(frozen=True)
class JobResult:
    """Host-side result of one job run (see `job_ettr` for the math)."""

    job: JobSchedule
    step_cct: np.ndarray         # [..., total_steps] barrier per ring step
    ettr: np.ndarray             # [...] compute / (compute + exposed comm)
    exposed_comm_ticks: np.ndarray  # [...] summed over iterations + phases
    # per step: every worker finished within the horizon.  A False entry
    # means that step's barrier is the horizon sentinel: the ETTR built on
    # it is an upper bound, not a measurement.
    finished: np.ndarray         # bool [..., total_steps]


def compile_job(
    arch: str | ArchConfig,
    *,
    workers: int = 4,
    tp: int = 8,
    shape: ShapeSpec | None = None,
    iterations: int = 2,
    pkt_bytes: float = 4096.0,
    pkt_scale: float = 64.0,
    min_shard: int = 16,
    max_shard: int = 2048,
    rate: int = 32,
    n_spines: int = 4,
    link_capacity: float = 8.0,
    latency_ticks: int = 4,
    overlap: Mapping[str, float] | None = None,
    include_allgather: bool = True,
) -> JobSchedule:
    """Compile a model config into a per-iteration collective schedule.

    `shape` defaults to a one-sample-per-rank training microbatch
    (`global_batch == workers`), the regime where gradient synchronization
    is actually exposed; the full-batch `SHAPES["train_4k"]` would bury
    communication under ~100x more compute and every policy would tie at
    ETTR ~= 1.  `workers` is the DP degree (each worker is one flow on the
    ring fabric) and `tp` the model-parallel degree that shards the
    parameter/gradient bytes before they hit the DCN fabric.
    """
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if shape is None:
        shape = ShapeSpec("train_micro", 4096, workers, "train")
    if iterations < 1:
        raise ValueError(f"need iterations >= 1, got {iterations}")
    overlap = dict(DEFAULT_OVERLAP, **(overlap or {}))
    terms = job_comm_terms(cfg, shape, dp=workers, tp=tp)

    bytes_per_sim_pkt = pkt_bytes * pkt_scale
    eff_rate = min(float(rate), n_spines * link_capacity)

    def shard_of(total_bytes: float) -> int:
        return int(
            np.clip(total_bytes / workers / bytes_per_sim_pkt, min_shard, max_shard)
        )

    def ideal_ticks(shard: int) -> float:
        return shard / eff_rate + latency_ticks + 1.0

    phase_specs = [("allreduce", terms["grad_bytes"], 2 * (workers - 1))]
    if include_allgather:
        phase_specs.append(("allgather", terms["param_bytes"], workers - 1))

    # calibration pass: tick_seconds anchors ideal comm ticks to ideal comm
    # seconds, then the compute window follows from the roofline ratio.
    prelim = [
        (kind, shard_of(b), steps) for kind, b, steps in phase_specs
    ]
    ideal_comm = sum(steps * ideal_ticks(shard) for _, shard, steps in prelim)
    t_comm_s = sum(
        terms[f"t_{kind}_s"] for kind, _, _ in phase_specs
    )
    tick_seconds = t_comm_s / max(ideal_comm, 1e-9)
    ratio = float(np.clip(terms["compute_comm_ratio"], 0.05, 50.0))
    compute_ticks = ratio * ideal_comm

    phases = tuple(
        JobPhase(
            kind=kind,
            shard_packets=shard,
            ring_steps=steps,
            overlap_ticks=overlap.get(kind, 0.0) * compute_ticks,
            ideal_step_ticks=ideal_ticks(shard),
        )
        for kind, shard, steps in prelim
    )
    return JobSchedule(
        arch=cfg.name,
        workers=workers,
        iterations=iterations,
        compute_ticks=compute_ticks,
        tick_seconds=tick_seconds,
        compute_comm_ratio=ratio,
        phases=phases,
    )


def total_packets(job: JobSchedule) -> int:
    """Total packets the schedule injects into the fabric over the whole
    job: workers x iterations x sum of phase payloads.  Conservation
    contract with `step_table`: equals `workers * step_table(job)[0].sum()`.
    """
    return job.workers * job.iterations * sum(
        p.payload_packets for p in job.phases
    )


def step_table(job: JobSchedule) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten the schedule into per-ring-step arrays (host, static).

    Returns ``(shard[S], phase_idx[S], planned_offset[S])`` with
    S = job.total_steps.  Planned offsets place each step on the job's
    IDEAL timeline: every iteration opens with its compute window, each
    phase starts as soon as its overlap budget allows (it may begin
    `overlap_ticks` before the compute window closes, but never before the
    previous phase's planned finish), and steps within a phase serialize at
    their fluid lower bound.  Scenario event schedules are read from these
    offsets (`scheduled_events`), which is what makes a mid-run link flap
    hit a mid-iteration step.
    """
    shard, phase_idx, offsets = [], [], []
    iter_start = 0.0
    for _ in range(job.iterations):
        compute_end = iter_start + job.compute_ticks
        cursor = iter_start  # planned finish of the previous phase
        for pi, ph in enumerate(job.phases):
            start = max(compute_end - ph.overlap_ticks, cursor, iter_start)
            cursor = start
            for _s in range(ph.ring_steps):
                shard.append(ph.shard_packets)
                phase_idx.append(pi)
                offsets.append(cursor)
                cursor += ph.ideal_step_ticks
        iter_start = max(cursor, compute_end)
    return (
        np.asarray(shard, np.int32),
        np.asarray(phase_idx, np.int32),
        np.asarray(np.round(offsets), np.int64),
    )


def scheduled_events(sched: EventSchedule, offsets: np.ndarray, horizon: int, *,
                     device=None) -> EventSchedule:
    """Re-base a scenario's event schedule at each planned step offset.

    `offsets` may have any shape (e.g. [S] or [models, S]); the returned
    `EventSchedule` tensors gain those leading axes:
    ``cap_scale[*offsets.shape, horizon, L]``.  Row t of slice o is the
    scenario's row min(o + t, T-1), the same "last row persists" contract
    as the fabric stepper, shifted to the step's planned start time.  The
    gather runs on the host in numpy; the result is moved to `device`
    (default: where `sched` lies) in one copy per tensor.
    """
    cap = _np(sched.cap_scale)
    bg = _np(sched.bg_arrivals)
    T = cap.shape[0]
    idx = np.minimum(np.asarray(offsets)[..., None] + np.arange(horizon), T - 1)
    dev = sched.cap_scale.device if device is None else device
    return EventSchedule(
        cap_scale=torch.as_tensor(np.asarray(cap[idx], np.float32), device=dev),
        bg_arrivals=torch.as_tensor(np.asarray(bg[idx], np.float32), device=dev),
    )


def job_step_inputs(
    jobs: Sequence[JobSchedule], sched: EventSchedule, horizon: int, *, device=None
) -> Tuple[EventSchedule, torch.Tensor]:
    """Build the batched runner inputs for M jobs sharing one scenario.

    Returns ``(scheds, shard)`` with scheds' tensors shaped
    [M, S, horizon, L] and shard int32 [M, S], both on `device` (default:
    where `sched` lies).  All jobs must share the schedule *structure*
    (workers, iterations, phase step counts) so S matches; shard sizes,
    compute windows and planned offsets are free to differ per model.
    """
    struct = {(j.workers, j.iterations, tuple(p.ring_steps for p in j.phases))
              for j in jobs}
    if len(struct) != 1:
        raise ValueError(
            f"jobs must share workers/iterations/phase structure, got {struct}"
        )
    tables = [step_table(j) for j in jobs]
    shard = np.stack([t[0] for t in tables])                    # [M, S]
    offsets = np.stack([t[2] for t in tables])                  # [M, S]
    scheds = scheduled_events(sched, offsets, horizon, device=device)
    return scheds, torch.as_tensor(shard, device=scheds.cap_scale.device)


def _step_runs(run, scheds, shard, key, on_run, lead):
    """Every step of one job run, as ``run(sched, n_packets, key)`` outputs:
    step s runs ``fold_in(key, s)`` on the scenario's rows for step s, and
    ``on_run(lead + (s,), out)`` sees each step's raw output."""
    S = int(shard.shape[0])
    keys = prng.fold_in(key, torch.arange(S, dtype=torch.int64, device=key.device))
    outs = []
    for s in range(S):
        out = run(frame_select(scheds, s), shard[s], keys[s])
        if on_run is not None:
            on_run(lead + (s,), out)
        outs.append(out)
    return outs


def _barriers(outs, spec):
    """``(cct[S], finished[S])`` of a job run's step outputs: the barrier
    (max over the workers) and the all-finished flag, plus the frames
    stacked on S when the spec carries telemetry."""
    ccts, fins, frames = [], [], []
    for out in outs:
        r = out
        if spec.telemetry is not None:
            r, frame = out
            frames.append(frame)
        ccts.append(r.cct.max())
        fins.append(r.finished.all())
    res = (torch.stack(ccts), torch.stack(fins))
    return res + (_stack_runs(frames, (len(outs),)),) if frames else res


def run_job_steps(
    topo: TopologyParams,
    scheds: EventSchedule,
    spec: SenderSpec,
    sp: SenderParams,
    shard: torch.Tensor,
    key: torch.Tensor,
    horizon: int = 2048,
    *,
    device="cuda",
    plain_spray: bool = False,
    on_run: Callable | None = None,
):
    """Barrier time of every schedule step.

    `scheds` carries a leading step axis S (from `scheduled_events`),
    `shard[S]` the per-step message sizes.  Step s folds s into `key`,
    runs the W coupled ring flows (`sender.run_flows_sized`) and reports
    the synchronous barrier (max over workers).  Returns ``(cct[S],
    finished[S])``: finished is True only when every worker completed
    within the horizon (False: the barrier is the sentinel).  With the
    engine's early exit each step stops at its own barrier.

    With `spec.telemetry` set the return value becomes ``(cct[S],
    finished[S], frame)`` where the frame's leaves carry a leading step
    axis S (`telemetry.frame_select(frame, s)` reads step s).
    ``plain_spray`` holds the WAM kernel to its plain version on the card
    (for tests); ``on_run((s,), out)`` is called after each step's run.
    """
    dev = resolve_device(device)
    topo, scheds = to_device(topo, dev), to_device(scheds, dev)
    shard = torch.as_tensor(shard).to(dev)

    def run(sched, n_packets, key):
        return _run_flows(topo, sched, spec, sp, n_packets, key, horizon, dev, plain_spray)

    return _barriers(_step_runs(run, scheds, shard, torch.as_tensor(key).to(dev), on_run, ()),
                     spec)


def _sweep_step_runs(run, scheds, points, shard, keys, on_run, lead):
    """Every step of every (point, draw, model), in that row-major order, as
    ``run(sched, sp, n_packets, key)`` outputs."""
    outs = []
    for p, point in enumerate(points):
        for d in range(keys.shape[0]):
            for m in range(int(shard.shape[0])):
                outs += _step_runs(functools.partial(run, sp=point), frame_select(scheds, m),
                                   shard[m], keys[d], on_run, lead + (p, d, m))
    return outs


def _sweep_barriers(outs, spec, axes):
    """The step outputs of a sweep over ``axes`` (point, draw, model) folded
    into ``(cct[*axes, S], finished[*axes, S])`` (and the frames)."""
    S = len(outs) // int(np.prod(axes))
    runs = [_barriers(outs[i:i + S], spec) for i in range(0, len(outs), S)]
    out = tuple(torch.stack([r[i] for r in runs]).reshape(axes + tuple(runs[0][i].shape))
                for i in range(2))
    if spec.telemetry is not None:
        out = out + (_stack_runs([r[2] for r in runs], axes),)
    return out


def _sweep_steps(topo, scheds, spec, points, shard, keys, horizon, dev, on_run, lead):
    def run(sched, n_packets, key, *, sp):
        return _run_flows(topo, sched, spec, sp, n_packets, key, horizon, dev, False)

    outs = _sweep_step_runs(run, scheds, points, shard, keys, on_run, lead)
    return _sweep_barriers(outs, spec, (len(points), int(keys.shape[0]), int(shard.shape[0])))


def sweep_job_steps(
    topo: TopologyParams,
    scheds: EventSchedule,
    spec: SenderSpec,
    sp: SenderParams,
    shard: torch.Tensor,
    keys: torch.Tensor,
    horizon: int = 2048,
    *,
    device="cuda",
):
    """The job sweep: policies x draws x models x steps.

    `sp` carries a leading policy/config axis P (`stack_params`), `keys`
    is [D, 2] PRNG draws, `scheds` / `shard` carry leading [M, S] axes
    (from `job_step_inputs`).  Returns ``(cct[P, D, M, S], finished[P, D,
    M, S])`` (and the frame with those leading axes under telemetry); each
    (point, draw, model) runs `run_job_steps` one after another."""
    points, dev = _points(sp), resolve_device(device)
    topo, scheds = to_device(topo, dev), to_device(scheds, dev)
    shard, keys = torch.as_tensor(shard).to(dev), _keys(keys, dev)
    return _sweep_steps(topo, scheds, spec, points, shard, keys, horizon, dev, None, ())


def sweep_job_steps_scenarios(
    topos: TopologyParams,
    scheds: EventSchedule,
    spec: SenderSpec,
    sp: SenderParams,
    shard: torch.Tensor,
    keys: torch.Tensor,
    horizon: int = 2048,
    *,
    device="cuda",
    on_run: Callable | None = None,
):
    """`sweep_job_steps` with a leading SCENARIO axis C on topology/events.

    `topos` carries stacked per-scenario `TopologyParams` (`stack_pytrees`)
    and `scheds` stacked [C, M, S, horizon, L] event schedules (one
    `job_step_inputs` per scenario, stacked).  `shard[M, S]` is
    scenario-independent.  Returns ``(cct[C, P, D, M, S], finished[...])``;
    scenario c computes exactly what ``sweep_job_steps(topos[c],
    scheds[c], ...)`` would, and ``on_run((c, p, d, m, s), out)`` sees
    each step's run."""
    points, dev = _points(sp), resolve_device(device)
    C = int(topos.route.shape[0])
    if scheds.cap_scale.dim() != 5 or int(scheds.cap_scale.shape[0]) != C:
        raise ValueError(f"{C} topologies need {C} stacked [M, S, horizon, L] schedules, "
                         f"got {tuple(scheds.cap_scale.shape)}")
    shard, keys = torch.as_tensor(shard).to(dev), _keys(keys, dev)
    runs = [_sweep_steps(to_device(frame_select(topos, c), dev),
                         to_device(frame_select(scheds, c), dev), spec, points, shard, keys,
                         horizon, dev, on_run, (c,))
            for c in range(C)]
    out = tuple(torch.stack([r[i] for r in runs]) for i in range(2))
    if spec.telemetry is not None:
        out = out + (_stack_runs([r[2] for r in runs], (C,)),)
    return out


def shard_run_job_steps(
    topo: TopologyParams,
    scheds: EventSchedule,
    spec: SenderSpec,
    sp: SenderParams,
    shard: torch.Tensor,
    key: torch.Tensor,
    horizon: int = 2048,
    *,
    mesh: Mesh | None = None,
):
    """`run_job_steps` with the W ring flows sharded over ``mesh``
    (`sender.flow_mesh`; default: every visible card): bit-identical
    ``(cct[S], finished[S])``.  Every rank runs every step on its block of
    the flows; a step's barrier is the max over all ranks' flows and its
    finished flag their AND, as in the reference.  Telemetry is not
    supported on this path."""
    mesh = flow_mesh() if mesh is None else mesh
    outs = _shard_runs(mesh, [topo], spec, horizon, lambda run, d: _step_runs(
        lambda sched, n, k: run(0, sched, sp, n, k), *d, None, ()),
        (scheds, torch.as_tensor(shard), torch.as_tensor(key)))
    return _barriers(outs, spec)


def shard_sweep_job_steps(
    topo: TopologyParams,
    scheds: EventSchedule,
    spec: SenderSpec,
    sp: SenderParams,
    shard: torch.Tensor,
    keys: torch.Tensor,
    horizon: int = 2048,
    *,
    mesh: Mesh | None = None,
):
    """`sweep_job_steps` sharded over the ring-flow axis: bit-identical
    ``(cct[P, D, M, S], finished[P, D, M, S])``, the policy, draw and model
    axes run one after another inside every rank."""
    mesh = flow_mesh() if mesh is None else mesh
    points, keys, shard = _points(sp), _keys(keys, "cpu"), torch.as_tensor(shard)
    outs = _shard_runs(mesh, [topo], spec, horizon, lambda run, d: _sweep_step_runs(
        lambda sched, n, k, *, sp: run(0, sched, sp, n, k), d[0], points, d[1], d[2], None,
        ()), (scheds, shard, keys))
    return _sweep_barriers(outs, spec, (len(points), int(keys.shape[0]), int(shard.shape[0])))


def job_ettr(
    job: JobSchedule, step_cct: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Fold per-step barriers into (ettr, exposed_comm_ticks).

    `step_cct[..., S]` may carry any leading sweep axes.  Per iteration and
    phase, exposed communication is max(0, phase CCT - overlap window);
    ETTR = compute / (compute + exposed), in (0, 1] by construction (zero
    exposure means the job runs at full accelerator utilization).
    """
    step_cct = np.asarray(_np(step_cct), np.float64)
    it, spi = job.iterations, job.steps_per_iteration
    arr = step_cct.reshape(step_cct.shape[:-1] + (it, spi))
    exposed = np.zeros(arr.shape[:-1], np.float64)  # [..., it]
    pos = 0
    for ph in job.phases:
        phase_cct = arr[..., pos:pos + ph.ring_steps].sum(axis=-1)
        exposed += np.maximum(phase_cct - ph.overlap_ticks, 0.0)
        pos += ph.ring_steps
    exposed_total = exposed.sum(axis=-1)            # [...]
    compute_total = job.compute_ticks * it
    ettr = compute_total / (compute_total + exposed_total)
    return ettr, exposed_total


def run_job(
    topo: TopologyParams,
    sched: EventSchedule,
    spec: SenderSpec,
    sp: SenderParams,
    job: JobSchedule,
    key: torch.Tensor,
    horizon: int = 2048,
    *,
    device="cuda",
):
    """Run one job under one scenario with scalar sender params.

    With `spec.telemetry` set, returns ``(JobResult, frame)``: the frame's
    leaves carry a leading step axis S (see `run_job_steps`)."""
    if topo.flows != job.workers:
        raise ValueError(
            f"topology has {topo.flows} flows but job.workers={job.workers}"
        )
    dev = resolve_device(device)
    shard, _, offsets = step_table(job)
    scheds = scheduled_events(sched, offsets, horizon, device=dev)
    out = run_job_steps(topo, scheds, spec, sp, torch.as_tensor(shard, device=dev), key,
                        horizon, device=dev)
    frame = None
    if spec.telemetry is not None:
        cct, finished, frame = out
    else:
        cct, finished = out
    cct, finished = _np(cct), _np(finished)
    ettr, exposed = job_ettr(job, cct)
    result = JobResult(
        job=job, step_cct=cct, ettr=ettr, exposed_comm_ticks=exposed,
        finished=finished,
    )
    return result if frame is None else (result, frame)


def sweep_job(
    topo: TopologyParams,
    sched: EventSchedule,
    spec: SenderSpec,
    sp: SenderParams,
    jobs: Sequence[JobSchedule],
    keys: torch.Tensor,
    horizon: int = 2048,
    *,
    mesh=None,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Host convenience over `sweep_job_steps`: M jobs x P policies x D
    draws under one scenario.  Returns ``{"cct": [P, D, M, S], "finished":
    [P, D, M, S], "ettr": [P, D, M], "exposed": [P, D, M]}`` as numpy;
    with `spec.telemetry` set, a "telemetry" key holds the
    `TelemetryFrame` whose leaves carry leading [P, D, M, S] sweep axes
    (peel with `telemetry.frame_select`).

    With ``mesh`` (a `sender.flow_mesh`) the raw sweep runs flow-sharded on
    the mesh's devices through `shard_sweep_job_steps`, and ``device`` is
    not read: bit-identical outputs, so every derived metric is too;
    telemetry capture is not supported sharded."""
    if any(topo.flows != j.workers for j in jobs):
        raise ValueError("every job's workers must equal the topology's flows")
    if mesh is not None:
        scheds, shard = job_step_inputs(jobs, sched, horizon, device=mesh.devices[0])
        out = shard_sweep_job_steps(topo, scheds, spec, sp, shard, keys, horizon, mesh=mesh)
    else:
        dev = resolve_device(device)
        scheds, shard = job_step_inputs(jobs, sched, horizon, device=dev)
        out = sweep_job_steps(topo, scheds, spec, sp, shard, keys, horizon, device=dev)
    frame = None
    if spec.telemetry is not None:
        cct, finished, frame = out
    else:
        cct, finished = out
    cct, finished = _np(cct), _np(finished)
    ettr = np.zeros(cct.shape[:-1])
    exposed = np.zeros(cct.shape[:-1])
    for m, job in enumerate(jobs):
        ettr[..., m], exposed[..., m] = job_ettr(job, cct[..., m, :])
    res = {"cct": cct, "finished": finished, "ettr": ettr, "exposed": exposed}
    if frame is not None:
        res["telemetry"] = frame
    return res
