"""Collective workloads over the multipath fabric: CCT and ETTR (§1).

The port of the JAX package's `net/collectives.py`.  AllReduce and
AllGather are modeled as their ring schedules: W workers, each step every
worker sends one shard (G/W bytes) to its neighbor concurrently; the step
completes when the SLOWEST worker's shard lands (synchronous barrier).

  CCT(allreduce) = sum over 2(W-1) steps of max-over-workers step time
  CCT(allgather) = sum over (W-1) steps of the same

On the independent-bundle fabric (`step_cct`, `allreduce_cct`,
`allgather_cct`) each worker's message runs on its own with its own key
(``split(step_key, W)``), one after another; the reference vmaps them.
The `_shared` variants run the same ring schedules on the shared
leaf-spine fabric (`repro_torch.net.topology`): each worker lives on its
own leaf and sends to its ring neighbor, so all W shard transfers of a
step contend for the same spine links (`sender.run_flows`, one run a
step, one after another).

ETTR here is the per-collective form for a job with per-iteration compute
time C:  ETTR = sum_i (C + CCT_ideal) / sum_i (C + CCT_i).  The job-level
pipeline lives in `repro_torch.net.jobs`.

Entry points run on the card by default (``device="cuda"``) and raise
when there is none; pass ``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.device import resolve_device
from repro_torch.net.fabric import FabricParams
from repro_torch.net.sender import (SenderParams, SenderSpec, _keys, _points, run_flows,
                                    to_device)
from repro_torch.net.telemetry import _np
from repro_torch.net.topology import EventSchedule, TopologyParams, leaf_spine
from repro_torch.net.transport import TransportConfig, simulate_flows, simulate_message
from repro_torch.numerics import fold_sum

__all__ = [
    "CollectiveConfig",
    "step_cct",
    "allreduce_cct",
    "allgather_cct",
    "ring_topology",
    "step_cct_shared",
    "ring_steps_cct_shared",
    "sweep_ring_cct_shared",
    "allreduce_cct_shared",
    "allgather_cct_shared",
    "ideal_step_ticks",
    "ettr",
]


@dataclasses.dataclass(frozen=True)
class CollectiveConfig:
    workers: int = 8
    shard_packets: int = 512   # packets per ring-step shard (G / W / pkt_size)
    horizon: int = 4096


def ideal_step_ticks(params: FabricParams, shard_packets: int, rate: int) -> float:
    """Fluid lower bound for one ring step: all paths healthy, perfect
    balance, sender rate-limited.  (numpy on a host copy, as the
    reference sums its float32 capacities.)"""
    agg_cap = float(np.sum(_np(params.capacity)))
    send_rate = min(agg_cap, float(rate))
    serialize = shard_packets / send_rate
    return serialize + float(np.min(_np(params.latency)))


def step_cct(
    params: FabricParams,
    tcfg: TransportConfig,
    cfg: CollectiveConfig,
    key: torch.Tensor,
    *,
    device="cuda",
) -> torch.Tensor:
    """Barrier time of one ring step = max over workers: worker w runs
    its message with key ``split(key, W)[w]``."""
    dev = resolve_device(device)
    params = to_device(params, dev)
    keys = prng.split(torch.as_tensor(key).to(dev), cfg.workers)
    ccts = [simulate_message(params, tcfg, cfg.shard_packets, keys[w], horizon=cfg.horizon,
                             device=dev).cct for w in range(cfg.workers)]
    return torch.stack(ccts).max()


def _ring_cct(params, tcfg, cfg, key, steps, device):
    dev = resolve_device(device)
    keys = prng.split(torch.as_tensor(key).to(dev), steps)
    per_step = torch.stack([step_cct(params, tcfg, cfg, keys[s], device=dev)
                            for s in range(steps)])
    return fold_sum(per_step), per_step


def allreduce_cct(
    params: FabricParams,
    tcfg: TransportConfig,
    cfg: CollectiveConfig,
    key: torch.Tensor,
    *,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total CCT, per-step barrier times) for a ring all-reduce."""
    return _ring_cct(params, tcfg, cfg, key, 2 * (cfg.workers - 1), device)


def allgather_cct(
    params: FabricParams,
    tcfg: TransportConfig,
    cfg: CollectiveConfig,
    key: torch.Tensor,
    *,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total CCT, per-step barrier times) for a ring all-gather."""
    return _ring_cct(params, tcfg, cfg, key, cfg.workers - 1, device)


def ettr(
    compute_ticks: float,
    ccts,
    ideal_cct: float,
) -> float:
    """Effective training time ratio across iterations."""
    ccts = np.asarray(_np(ccts), dtype=np.float64)
    total = np.sum(compute_ticks + ccts)
    ideal = len(ccts) * (compute_ticks + ideal_cct)
    return float(ideal / total)


def ring_topology(workers: int, n_spines: int = 4, **kw) -> TopologyParams:
    """Leaf-spine placement for a ring collective: worker w on leaf w always
    sends its shard to leaf (w+1) % workers, one coupled flow per worker."""
    return leaf_spine(
        workers, n_spines, [(w, (w + 1) % workers) for w in range(workers)], **kw
    )


def step_cct_shared(
    topo: TopologyParams,
    sched: EventSchedule,
    tcfg: TransportConfig,
    cfg: CollectiveConfig,
    key: torch.Tensor,
    *,
    device="cuda",
) -> torch.Tensor:
    """Barrier time of one ring step with all workers contending on the
    shared fabric = max over the coupled flows' completion times."""
    return simulate_flows(topo, sched, tcfg, cfg.shard_packets, key, horizon=cfg.horizon,
                          device=device).cct.max()


def _ring_steps(topo, sched, spec, sp, shard_packets, keys, horizon, dev):
    runs = [run_flows(topo, sched, spec, sp, shard_packets, keys[s], horizon, device=dev)
            for s in range(keys.shape[0])]
    return (torch.stack([r.cct.max() for r in runs]),
            torch.stack([r.finished.all() for r in runs]))


def ring_steps_cct_shared(
    topo: TopologyParams,
    sched: EventSchedule,
    spec: SenderSpec,
    sp: SenderParams,
    shard_packets: int,
    keys: torch.Tensor,
    horizon: int = 4096,
    *,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Barrier times for every ring step, one coupled-flows run per step
    key (`keys` is [steps, 2]).  Returns ``(per_step[steps],
    finished[steps])``: the max-over-workers CCT of each step plus a mask
    that is True only when EVERY worker finished within the horizon (a
    False entry means the barrier time is the horizon sentinel)."""
    dev = resolve_device(device)
    topo, sched = to_device(topo, dev), to_device(sched, dev)
    return _ring_steps(topo, sched, spec, sp, shard_packets, _keys(keys, dev), horizon, dev)


def sweep_ring_cct_shared(
    topo: TopologyParams,
    sched: EventSchedule,
    spec: SenderSpec,
    sp: SenderParams,
    shard_packets: int,
    keys: torch.Tensor,
    horizon: int = 4096,
    *,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Policy/config sweep of a shared-fabric ring: `sp` carries a leading
    sweep axis P (`stack_params`), `keys` is [steps, 2]; returns
    ``(per_step[P, steps], finished[P, steps])``, each point run one
    after another."""
    points, dev = _points(sp), resolve_device(device)
    topo, sched, keys = to_device(topo, dev), to_device(sched, dev), _keys(keys, dev)
    runs = [_ring_steps(topo, sched, spec, p, shard_packets, keys, horizon, dev)
            for p in points]
    return torch.stack([r[0] for r in runs]), torch.stack([r[1] for r in runs])


def _ring_cct_shared(topo, sched, tcfg, cfg, key, steps, device):
    dev = resolve_device(device)
    keys = prng.split(torch.as_tensor(key).to(dev), steps)
    per_step, finished = ring_steps_cct_shared(
        topo, sched, tcfg.spec(), tcfg.params(), cfg.shard_packets, keys, cfg.horizon,
        device=dev)
    return fold_sum(per_step), per_step, finished


def _check_workers(topo: TopologyParams, cfg: CollectiveConfig) -> None:
    if topo.flows != cfg.workers:
        raise ValueError(
            f"topology has {topo.flows} flows but cfg.workers={cfg.workers}"
        )


def allreduce_cct_shared(
    topo: TopologyParams,
    sched: EventSchedule,
    tcfg: TransportConfig,
    cfg: CollectiveConfig,
    key: torch.Tensor,
    *,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total CCT, per-step barriers, per-step finished mask) for a ring
    all-reduce whose workers share the fabric.  `topo` should come from
    `ring_topology(cfg.workers)`.  A False entry in the finished mask means
    that step's barrier is the horizon sentinel, not a measurement: treat
    the total as a lower bound."""
    _check_workers(topo, cfg)
    return _ring_cct_shared(topo, sched, tcfg, cfg, key, 2 * (cfg.workers - 1), device)


def allgather_cct_shared(
    topo: TopologyParams,
    sched: EventSchedule,
    tcfg: TransportConfig,
    cfg: CollectiveConfig,
    key: torch.Tensor,
    *,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`allreduce_cct_shared` for a ring all-gather: W - 1 steps."""
    _check_workers(topo, cfg)
    return _ring_cct_shared(topo, sched, tcfg, cfg, key, cfg.workers - 1, device)
