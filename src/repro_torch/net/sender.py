"""The flow-batched sender engine: one tick core for every entry point.

`run_sender` holds the paper's sender semantics (emit budget, spraying,
retransmission debt, the delayed-feedback profile controller, completion
detection) as a Python loop over ticks.  `run_message` / `run_message_on`
are its single-flow form and `run_flows` / `run_flows_sized` its F-flow
form on a shared fabric.  The policy is a concrete id, so each run
executes only its own branch; the WAM branch launches the `spray_select`
kernel once per tick for all flows.  A `TelemetrySpec` on the spec records
a `TelemetryFrame` as the run goes (`repro_torch.net.telemetry`).

The sweeps (`sweep_message`, `sweep_flows`, `sweep_flows_scenarios`) take
`SenderParams` with a leading point axis P (`stack_params`,
`policy_sweep_params`) and D PRNG keys, and run each (scenario, point,
draw) as its own run, one after another: every slice is bit for bit the
unbatched run, and results gain the reference's leading axes.

The flow-sharded engines (`shard_run_flows`, `shard_sweep_flows`,
`shard_sweep_flows_scenarios`) split the flow axis over the ranks of a
`flow_mesh`, one thread a rank with a private process group
(`repro_torch.ranks`), and give the unsharded results bit for bit (see the
section at the end of this module).

Random numbers follow the reference's key streams exactly: the per-tick
keys are split from one loop key up front (`tick_keys`), and each chunk of
ticks draws its mole uniforms and per-lane integers in one batched call.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence, Tuple

import torch

from repro_torch import random as prng
from repro_torch.core.feedback import (ControllerState, PathStats, controller_step,
                                       make_controller)
from repro_torch.core.profile import make_profile, uniform_profile
from repro_torch.core.spray import SprayMethod, SprayState
from repro_torch.device import resolve_device
from repro_torch.kernels.link_fold import LinkSegments
from repro_torch.net.fabric import FabricParams, fabric_tick, init_fabric
from repro_torch.net.policies import (ALL_POLICIES, BASELINE_POLICIES, Policy,
                                      assign_lanes, blocks_for, profile_adaptive,
                                      uses_rng)
from repro_torch.net.policy_state import (PolicyState, init_policy_state,
                                          update_policy_state)
from repro_torch.net.telemetry import (TelemetryFrame, TelemetrySpec, frame_select,
                                       init_frame, record)
from repro_torch.net.topology import (EventSchedule, TopologyParams,
                                      init_shared_fabric, link_telemetry,
                                      shared_fabric_tick)
from repro_torch.numerics import fold_sum
from repro_torch.random import M32
from repro_torch.ranks import DEFAULT_TIMEOUT, Mesh, RankComm, run_ranks

__all__ = ["Policy", "BASELINE_POLICIES", "ALL_POLICIES", "SenderSpec",
           "SenderParams", "SimResult", "sender_params", "stack_params",
           "policy_sweep_params", "spec_for_policies", "completion_need",
           "assign_paths", "tick_keys", "fabric_quiescent", "run_sender",
           "run_message_on", "run_message", "run_flows", "run_flows_sized",
           "sweep_message", "sweep_flows", "sweep_flows_scenarios",
           "resolve_device", "to_device", "FLOW_AXIS", "Mesh", "flow_mesh",
           "shard_run_flows", "shard_sweep_flows", "shard_sweep_flows_scenarios"]


@dataclasses.dataclass(frozen=True)
class SenderSpec:
    """Shape-affecting sender description (see `repro.net.sender`)."""

    coded: bool = True
    ell: int = 10
    method: SprayMethod = SprayMethod.SHUFFLE_1
    rate_cap: int = 32
    early_exit: bool = False
    exit_chunk: int = 64
    telemetry: TelemetrySpec | None = None
    state_blocks: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class SenderParams:
    """Sender knobs as concrete Python values (the policy picks a branch),
    or, stacked by `stack_params` for a sweep, as tensors with a leading
    point axis (int32 policy, rate and ctrl_interval, float32 cwnd and
    code_overhead, uint32 seeds held in int64)."""

    policy: int
    rate: int
    cwnd: float
    code_overhead: float
    ctrl_interval: int
    sa: int
    sb: int


def sender_params(policy: Policy | int, *, rate: int = 32, cwnd: float = 256.0,
                  code_overhead: float = 0.05, ctrl_interval: int = 4,
                  seed: Tuple[int, int] = (333, 735)) -> SenderParams:
    return SenderParams(policy=int(policy), rate=int(rate), cwnd=float(cwnd),
                        code_overhead=float(code_overhead),
                        ctrl_interval=int(ctrl_interval),
                        sa=int(seed[0]) & M32, sb=int(seed[1]) & M32)


_PARAM_DTYPES = dict(policy=torch.int32, rate=torch.int32, cwnd=torch.float32,
                     code_overhead=torch.float32, ctrl_interval=torch.int32,
                     sa=torch.int64, sb=torch.int64)


def stack_params(params: Sequence[SenderParams]) -> SenderParams:
    """Stack scalar params on a new leading sweep axis."""
    params = list(params)
    if not params:
        raise ValueError("need at least one SenderParams to stack")
    return SenderParams(**{
        name: torch.tensor([getattr(p, name) for p in params], dtype=dtype)
        for name, dtype in _PARAM_DTYPES.items()})


def policy_sweep_params(policies: Sequence[Policy] = BASELINE_POLICIES, **kw) -> SenderParams:
    """`SenderParams` with a leading policy axis (default: the five
    baseline policies); pair `ALL_POLICIES` with `spec_for_policies`."""
    return stack_params([sender_params(p, **kw) for p in policies])


def _points(sp: SenderParams) -> list:
    """The scalar params of each point of a stacked `sp`."""
    if not torch.is_tensor(sp.policy) or sp.policy.dim() != 1:
        raise ValueError("a sweep takes SenderParams stacked on one leading axis "
                         "(stack_params / policy_sweep_params)")
    P = int(sp.policy.shape[0])
    return [SenderParams(**{
        name: (float if dtype.is_floating_point else int)(getattr(sp, name)[i])
        for name, dtype in _PARAM_DTYPES.items()}) for i in range(P)]


def spec_for_policies(spec: SenderSpec, policies: Sequence[Policy | int]) -> SenderSpec:
    return dataclasses.replace(spec, state_blocks=blocks_for(policies))


@dataclasses.dataclass(frozen=True)
class SimResult:
    cct: torch.Tensor            # float32[*lead] completion tick or horizon
    sent_total: torch.Tensor     # float32[*lead, n]
    dropped_total: torch.Tensor  # float32[*lead, n]
    final_b: torch.Tensor        # int32[*lead, n]
    received: torch.Tensor       # float32[*lead]
    finished: torch.Tensor       # bool[*lead]
    link_served: torch.Tensor    # float32[*sweep, L] or [*sweep, 0]
    link_busy: torch.Tensor      # float32[*sweep, L] or [*sweep, 0]
    ticks_run: torch.Tensor      # int64[*sweep]: ticks executed (fewer than
                                 # the horizon when early exit skipped
                                 # settled ones)


def _on(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (device.index is None
                                             or t.device.index == device.index)


def to_device(obj, device):
    """A dataclass of tensors with every tensor on `device`: `obj` itself
    when they all are (so what it caches stays), else a copy."""
    device = torch.device(device)
    names = [f.name for f in dataclasses.fields(obj)
             if isinstance(getattr(obj, f.name), torch.Tensor)]
    if all(_on(getattr(obj, k), device) for k in names):
        return obj
    return dataclasses.replace(obj, **{k: getattr(obj, k).to(device) for k in names})


def completion_need(n_packets, coded: bool, code_overhead: float,
                    device=None) -> torch.Tensor:
    """Arrivals a flow needs, less a 0.25 float-residue guard: K(1+eps)
    distinct packets (floor, +1) when coded, all K otherwise; messages of
    at most 4 packets waive the overhead."""
    npk = torch.as_tensor(n_packets, device=device).to(torch.float32)
    if coded:
        overhead = npk * torch.full((), code_overhead, dtype=torch.float32, device=device)
        need = torch.floor(npk + overhead) + 1.0
    else:
        need = npk
    need = torch.where(npk <= 4.0, npk, need)
    return need - 0.25


def assign_paths(policy, rate_cap: int, n: int, spray: SprayState, profile,
                 k_emit: torch.Tensor, rand_lanes, ecmp_path, pstate: PolicyState,
                 *, plain_spray: bool = False):
    """Paths for up to rate_cap packets per flow (the first k_emit live),
    summed onto their paths: returns (arrivals float32[F, n], spray')."""
    paths = assign_lanes(policy, rate_cap, n, spray, profile, ecmp_path, pstate,
                         rand_lanes, plain_spray=plain_spray)
    lanes = torch.arange(rate_cap, device=paths.device)
    live = lanes < k_emit.unsqueeze(-1)
    hits = (paths.unsqueeze(-2) == torch.arange(n, device=paths.device).unsqueeze(-1))
    arrivals = (hits & live.unsqueeze(-2)).sum(-1).to(torch.float32)
    spray = dataclasses.replace(spray, j=(spray.j + k_emit.to(torch.int64)) & M32)
    return arrivals, spray


def tick_keys(k_loop: torch.Tensor, horizon: int) -> torch.Tensor:
    """Row t is ``split(fold_in(k_loop, t))``: [horizon, 2, 2]."""
    t = torch.arange(horizon, dtype=torch.int64, device=k_loop.device)
    return prng.split(prng.fold_in(k_loop, t), 2)


def fabric_quiescent(state) -> torch.Tensor:
    """No flow traffic left in queues, the delivery ring, the pending-drop
    feedback ring or the store-and-forward pipeline."""
    parts = [state.queue, state.arrive_ring, state.drop_ring]
    forward = getattr(state, "forward", None)
    if forward is not None:
        parts.append(forward)
    quiet = torch.ones((), dtype=torch.bool, device=parts[0].device)
    for p in parts:
        quiet = quiet & (p == 0).all()
    return quiet


@dataclasses.dataclass
class _Carry:
    fabric: object
    ctrl: ControllerState
    spray: SprayState
    sent_sched: torch.Tensor
    debt: torch.Tensor
    done_at: torch.Tensor
    sent_pp: torch.Tensor
    known_delivered: torch.Tensor
    known_dropped: torch.Tensor
    pstate: PolicyState


def _settled_on_device(spec: SenderSpec, c: _Carry) -> torch.Tensor:
    """Every flow done, ARQ debt drained, fabric quiescent (absorbing), as
    a device predicate."""
    done = (c.done_at >= 0).all() & fabric_quiescent(c.fabric)
    if not spec.coded:
        done = done & (c.debt == 0).all()
    return done


def _settled(spec: SenderSpec, c: _Carry) -> bool:
    return bool(_settled_on_device(spec, c))


def run_sender(spec: SenderSpec, sp: SenderParams, n_packets, horizon: int, *,
               n: int, fabric0, stepper: Callable, mole_size: int,
               latency_f: torch.Tensor, spray0: SprayState, ctrl0: ControllerState,
               ecmp_path: torch.Tensor, lane_keys: Callable, received_fn: Callable,
               dropped_fn: Callable, k_loop: torch.Tensor,
               link_fn: Callable | None = None,
               tel_link_fn: Callable | None = None, links: int = 0,
               plain_spray: bool = False, settle_reduce: Callable | None = None):
    """The sender tick core over F flows (F = 1 for one message).

    stepper(fabric, arrivals[F, n], u[mole_size]) -> (fabric', fb) is the
    fabric.  ``lane_keys(ka)`` turns a chunk's lane keys ``[T, 2]`` into
    each flow's key of each tick, ``[T, F, 2]``.  ``settle_reduce(pred)``
    makes the early-exit predicate of a flow-sharded rank the all-rank one
    (a bool every rank agrees on), so every rank runs the same chunks.
    ``tel_link_fn(fabric)`` reads the per-link telemetry (queue, served,
    dropped, ecn) of the fabric's ``links`` links, where it has them.
    ``plain_spray`` sends the WAM branch through the kernel's plain version
    even on the card; it exists so a test can hold the kernel to it.

    With ``spec.telemetry`` set the run returns ``(SimResult, frame)``: on
    every tick t with ``t % stride == 0`` the frame records the state after
    the tick where the run had not settled before it (a device predicate,
    and the tick is written with a fill, so a stride tick adds no wait for
    the card).  Other ticks skip `record`, which there would rewrite every
    slot with its own value."""
    tspec = spec.telemetry
    if tspec is not None and not isinstance(tspec, TelemetrySpec):
        raise TypeError(f"SenderSpec.telemetry must be a TelemetrySpec, got {type(tspec)}")
    dev = latency_f.device
    F = int(spray0.j.shape[0])
    lead = (F,)
    policy = Policy(int(sp.policy))
    need = completion_need(n_packets, spec.coded, sp.code_overhead, device=dev)
    npk = torch.as_tensor(n_packets, device=dev).to(torch.float32)
    rate = min(sp.rate, spec.rate_cap)
    adaptive = profile_adaptive(policy)
    tkeys = tick_keys(k_loop, horizon)
    pstate0 = init_policy_state(spec.state_blocks, lead, n, latency=latency_f,
                                sa=spray0.sa)
    rng_hi = None
    if uses_rng(policy, pstate0):
        rng_hi = n if policy != Policy.RAND_ADAPTIVE else ctrl0.profile.m
    # scalars are filled on the device (`torch.tensor` of a host value
    # would copy it and wait for the card)
    cwnd = torch.full((), sp.cwnd, dtype=torch.float32, device=dev)
    zeros = torch.zeros(lead, device=dev)

    def tick(c: _Carry, u: torch.Tensor, rand_lanes) -> _Carry:
        t = c.fabric.t
        if spec.coded:
            k_emit = torch.where(c.done_at >= 0, 0, rate).to(torch.int32)
        else:
            outstanding = torch.clamp_min(npk - c.sent_sched, 0.0) + c.debt
            in_flight = (fold_sum(c.sent_pp) - c.known_delivered) - c.known_dropped
            room = torch.clamp_min(cwnd - in_flight, 0.0)
            k_emit = torch.ceil(torch.clamp_max(torch.minimum(outstanding, room),
                                                float(rate))).to(torch.int32)
        arrivals, spray = assign_paths(policy, spec.rate_cap, n, c.spray,
                                       c.ctrl.profile, k_emit, rand_lanes,
                                       ecmp_path, c.pstate, plain_spray=plain_spray)
        sent_pp = c.sent_pp + arrivals
        fabric, fb = stepper(c.fabric, arrivals, u)

        sent_m = torch.clamp_min(fb["sent"], 1e-6)
        seen1 = torch.clamp_max(fb["sent"], 1.0)
        ecn_rate = fb["marked"] / sent_m * seen1
        loss_rate = fb["dropped"] / sent_m * seen1
        rtt = latency_f + fb["qdelay"]
        pstate = c.pstate
        if spec.state_blocks:
            pstate = update_policy_state(pstate, ecn_rate=ecn_rate, loss_rate=loss_rate,
                                         rtt_sample=rtt, seen=fb["sent"] > 0)
        debt, known_delivered, known_dropped = c.debt, c.known_delivered, c.known_dropped
        if not spec.coded or tspec is not None:
            # a coded run's debt changes nothing; only telemetry reads it
            fb_dropped = fold_sum(fb["dropped"])
            unsent = torch.clamp_min(npk - c.sent_sched, 0.0)
            debt = (c.debt + fb_dropped) - torch.clamp_min(k_emit - unsent, 0.0)
            debt = torch.clamp_min(debt, 0.0)
        if not spec.coded:
            known_delivered = known_delivered + fb["landed"]
            known_dropped = known_dropped + fb_dropped
        sent_sched = c.sent_sched + k_emit

        ctrl = c.ctrl
        if adaptive and t % sp.ctrl_interval == 0:
            ctrl, _ = controller_step(ctrl, PathStats(ecn_rate=ecn_rate,
                                                      loss_rate=loss_rate, rtt=rtt))
        done_now = (received_fn(fabric) >= need) & (c.done_at < 0)
        done_at = torch.where(done_now, t + 1, c.done_at).to(torch.int32)
        return _Carry(fabric, ctrl, spray, sent_sched, debt, done_at, sent_pp,
                      known_delivered, known_dropped, pstate)

    m = 1 << spec.ell

    def observe(c: _Carry, tel: TelemetryFrame, u, rand_lanes):
        """One tick, recorded on stride ticks where the run had not
        settled before it."""
        t_pre = c.fabric.t
        if t_pre % tspec.stride:
            return tick(c, u, rand_lanes), tel
        capture = ~_settled_on_device(spec, c)
        c = tick(c, u, rand_lanes)
        link = tel_link_fn(c.fabric) if tspec.links and tel_link_fn is not None else None
        tel = record(tspec, tel, capture, tick=t_pre, m=m, alloc=c.ctrl.profile.b,
                     sent_pp=c.sent_pp, dropped_pp=dropped_fn(c.fabric), debt=c.debt,
                     emitted=c.sent_sched, received=received_fn(c.fabric), j=c.spray.j,
                     link=link, pen=c.pstate.penalty, ccw=c.pstate.ccw)
        return c, tel

    def run(c: _Carry, tel, keys: torch.Tensor):
        """Run one tick per row of keys [T, 2, 2], drawing the chunk's
        random numbers in one batched call."""
        u = prng.uniform(keys[:, 1], (mole_size,))
        lanes = None
        if rng_hi is not None:
            ka = lane_keys(keys[:, 0])
            lanes = prng.randint(ka, (spec.rate_cap,), 0, rng_hi)
        for i in range(keys.shape[0]):
            lane_i = None if lanes is None else lanes[i]
            if tel is None:
                c = tick(c, u[i], lane_i)
            else:
                c, tel = observe(c, tel, u[i], lane_i)
        return c, tel

    done_at0 = torch.where(need <= 0.0, 0, -1).to(torch.int32).expand(lead).clone()
    carry = _Carry(fabric0, ctrl0, spray0, zeros, zeros, done_at0,
                   torch.zeros(lead + (n,), device=dev), zeros, zeros, pstate0)
    tel = None
    if tspec is not None:
        tel = init_frame(tspec, lead, n, links if tel_link_fn is not None else 0,
                         pen_width=pstate0.penalty.shape[-1],
                         ccw_width=pstate0.ccw.shape[-1], device=dev)
    def settled(c: _Carry) -> bool:
        if settle_reduce is None:
            return _settled(spec, c)
        return settle_reduce(_settled_on_device(spec, c))

    chunk = max(1, min(spec.exit_chunk, horizon))
    n_full, rem = divmod(horizon, chunk)
    i = 0
    while i < n_full and not (spec.early_exit and settled(carry)):
        carry, tel = run(carry, tel, tkeys[i * chunk:(i + 1) * chunk])
        i += 1
    if rem:
        carry, tel = run(carry, tel, tkeys[n_full * chunk:])
    ticks_run = i * chunk + rem

    done_at = carry.done_at
    cct = torch.where(done_at >= 0, done_at.to(torch.float32),
                      torch.full((), float(horizon), device=dev))
    if link_fn is not None:
        link_served, link_busy = link_fn(carry.fabric)
    else:
        link_served = link_busy = torch.zeros((0,), device=dev)
    result = SimResult(cct=cct, sent_total=carry.sent_pp,
                       dropped_total=dropped_fn(carry.fabric),
                       final_b=carry.ctrl.profile.b, received=received_fn(carry.fabric),
                       finished=done_at >= 0, link_served=link_served,
                       link_busy=link_busy,
                       ticks_run=torch.full((), ticks_run, dtype=torch.int64, device=dev))
    return result if tel is None else (result, tel)


_FLOW_CHANNELS = ("alloc", "sent_pp", "dropped_pp", "debt", "emitted", "received", "disc",
                  "pstate_pen", "pstate_ccw")


def _squeeze_flow(out):
    """Drop the flow axis of 1 of a single-flow run (and of its frame)."""
    r, tel = out if isinstance(out, tuple) else (out, None)
    r = dataclasses.replace(r, **{
        k: getattr(r, k)[0] for k in ("cct", "sent_total", "dropped_total",
                                      "final_b", "received", "finished")})
    if tel is None:
        return r
    tel = dataclasses.replace(
        tel, prev_sent=tel.prev_sent[0], prev_j=tel.prev_j[0],
        **{k: getattr(tel, k)[:, 0] for k in _FLOW_CHANNELS})
    return r, tel


def run_message_on(fabric0, stepper, latency: torch.Tensor, spec: SenderSpec,
                   sp: SenderParams, n_packets: int, key: torch.Tensor,
                   horizon: int = 4096, *, mole_size: int, received_fn=None,
                   dropped_fn=None):
    """One flow over an arbitrary fabric stepper.

    ``stepper(state, arrivals[1, n], u[mole_size])`` advances the fabric one
    tick with the tick's mole draw and returns (state', fb) with feedback
    entries ``[1, n]`` (landed ``[1]``); ``received_fn`` / ``dropped_fn``
    read ``[1]`` / ``[1, n]`` out of the state."""
    dev = latency.device
    n = int(latency.shape[-1])
    if received_fn is None:
        received_fn = lambda s: s.received  # noqa: E731
    if dropped_fn is None:
        dropped_fn = lambda s: s.dropped  # noqa: E731
    prof = uniform_profile(n, spec.ell, device=dev)
    ctrl0 = make_controller(make_profile(prof.b.unsqueeze(0), spec.ell))
    mask = (1 << spec.ell) - 1
    spray0 = SprayState(
        j=torch.zeros(1, dtype=torch.int64, device=dev),
        sa=torch.full((1,), sp.sa & mask, dtype=torch.int64, device=dev),
        sb=torch.full((1,), (sp.sb & mask) | 1, dtype=torch.int64, device=dev),
        ell=spec.ell, method=int(spec.method))
    keys = prng.split(key.to(dev), 2)
    ecmp = prng.randint(keys[0], (), 0, n).reshape(1)
    r = run_sender(spec, sp, n_packets, horizon, n=n, fabric0=fabric0,
                   stepper=stepper, mole_size=mole_size,
                   latency_f=latency.to(torch.float32).reshape(1, n),
                   spray0=spray0, ctrl0=ctrl0, ecmp_path=ecmp,
                   lane_keys=lambda ka: ka.unsqueeze(1),
                   received_fn=received_fn, dropped_fn=dropped_fn, k_loop=keys[1])
    return _squeeze_flow(r)


def run_message(params: FabricParams, spec: SenderSpec, sp: SenderParams,
                n_packets: int, key: torch.Tensor, horizon: int = 4096, *,
                device="cuda"):
    """One message on the independent-bundle fabric."""
    dev = resolve_device(device)
    params = to_device(params, dev)

    def stepper(state, arrivals, u):
        return fabric_tick(params, state, arrivals, u)

    return run_message_on(init_fabric(params, (1,)), stepper, params.latency, spec,
                          sp, n_packets, key, horizon, mole_size=params.n)


def _run_flows(topo: TopologyParams, sched: EventSchedule, spec: SenderSpec,
               sp: SenderParams, n_packets, key: torch.Tensor, horizon: int,
               device, plain_spray: bool, block: "_FlowBlock | None" = None) -> SimResult:
    """`run_flows_sized`; with ``block``, the block of one rank of a
    flow-sharded run: ``topo`` is then the flow-padded topology and the
    result holds the block's flows (the link counters are every flow's)."""
    dev = resolve_device(device)
    topo, sched = to_device(topo, dev), to_device(sched, dev)
    n = topo.n
    if block is None:
        block = _FlowBlock(None, topo.flows, topo.flows, None)
    F = block.flows
    topo = block.local_topology(topo)
    mask = (1 << spec.ell) - 1
    fidx = torch.arange(block.lo, block.lo + block.size, dtype=torch.int64, device=dev)
    prof = uniform_profile(n, spec.ell, device=dev)
    ctrl0 = make_controller(make_profile(prof.b.expand(block.size, n), spec.ell))
    spray0 = SprayState(
        j=torch.zeros(block.size, dtype=torch.int64, device=dev),
        sa=(sp.sa + fidx * 0x9E3779B9) & mask,
        sb=((sp.sb + 2 * fidx) & mask) | 1,
        ell=spec.ell, method=int(spec.method))
    keys = prng.split(key.to(dev), 2)
    # every per-flow draw is made at the real flow count F, then padded and
    # sliced: threefry splits are not prefix-stable in their count
    ecmp = block.local(prng.randint(keys[0], (F,), 0, n), 0)
    if torch.is_tensor(n_packets):
        n_packets = n_packets.to(dev)
    if block.comm is not None:
        n_packets = block.local(torch.as_tensor(n_packets, device=dev).expand(F), 0, fill=0)

    def stepper(state, arrivals, u):
        return shared_fabric_tick(topo, sched, state, arrivals, u, gather=block.gather,
                                  segments=block.segments)

    return run_sender(
        spec, sp, n_packets, horizon, n=n, fabric0=init_shared_fabric(topo),
        stepper=stepper, mole_size=topo.links,
        latency_f=topo.latency.to(torch.float32), spray0=spray0, ctrl0=ctrl0,
        ecmp_path=ecmp, lane_keys=lambda ka: block.local(prng.split(ka, F), 1),
        received_fn=lambda s: s.received,
        dropped_fn=lambda s: s.dropped, k_loop=keys[1],
        link_fn=lambda s: (s.link_served, s.link_busy),
        tel_link_fn=lambda s: link_telemetry(topo, s), links=topo.links,
        plain_spray=plain_spray,
        settle_reduce=None if block.comm is None else block.comm.all_true)


def run_flows(topo: TopologyParams, sched: EventSchedule, spec: SenderSpec,
              sp: SenderParams, n_packets: int, key: torch.Tensor,
              horizon: int = 4096, *, device="cuda", plain_spray: bool = False):
    """F coupled flows, one n_packets message each, on one shared fabric;
    flow f sprays with seed (sa + f * 0x9E3779B9, sb + 2f)."""
    return _run_flows(topo, sched, spec, sp, n_packets, key, horizon, device,
                      plain_spray)


def run_flows_sized(topo: TopologyParams, sched: EventSchedule, spec: SenderSpec,
                    sp: SenderParams, n_packets, key: torch.Tensor,
                    horizon: int = 4096, *, device="cuda"):
    """`run_flows` with a per-flow message size (int or int tensor [F]);
    size-0 flows complete at tick 0."""
    return _run_flows(topo, sched, spec, sp, n_packets, key, horizon, device, False)


def _stack_runs(runs: list, lead: Tuple[int, ...]):
    """Stack runs (SimResults, or (SimResult, frame) pairs) given in
    row-major order of the sweep axes `lead` onto those axes."""
    def stack(objs):
        return dataclasses.replace(objs[0], **{
            f.name: torch.stack([getattr(o, f.name) for o in objs]).reshape(
                lead + tuple(getattr(objs[0], f.name).shape))
            for f in dataclasses.fields(objs[0])})

    if isinstance(runs[0], tuple):
        return stack([r for r, _ in runs]), stack([t for _, t in runs])
    return stack(runs)


def _keys(keys: torch.Tensor, dev) -> torch.Tensor:
    keys = torch.as_tensor(keys).to(dev)
    if keys.dim() != 2 or keys.shape[-1] != 2:
        raise ValueError(f"keys must be [D, 2], got {tuple(keys.shape)}")
    return keys


def _sweep(run_one, points, keys, scenarios, on_run=None):
    """Every (scenario, point, draw) run in row-major order, each reported
    to ``on_run(index, out)`` as it finishes."""
    runs = []
    for c, scenario in enumerate(scenarios):
        for p, point in enumerate(points):
            for d in range(keys.shape[0]):
                out = run_one(scenario, point, keys[d])
                if on_run is not None:
                    on_run((c, p, d), out)
                runs.append(out)
    return runs


def sweep_message(params: FabricParams, spec: SenderSpec, sp: SenderParams,
                  n_packets: int, keys: torch.Tensor, horizon: int = 4096, *,
                  device="cuda"):
    """`run_message` over P stacked points x D keys: fields gain [P, D]."""
    points, dev = _points(sp), resolve_device(device)
    params, keys = to_device(params, dev), _keys(keys, dev)
    runs = _sweep(lambda prm, p, k: run_message(prm, spec, p, n_packets, k, horizon,
                                                 device=dev),
                  points, keys, [params])
    return _stack_runs(runs, (len(points), keys.shape[0]))


def sweep_flows(topo: TopologyParams, sched: EventSchedule, spec: SenderSpec,
                sp: SenderParams, n_packets: int, keys: torch.Tensor,
                horizon: int = 4096, *, device="cuda"):
    """`run_flows` over P stacked points x D keys: ``cct[P, D, F]``."""
    points, dev = _points(sp), resolve_device(device)
    topo, sched, keys = to_device(topo, dev), to_device(sched, dev), _keys(keys, dev)
    runs = _sweep(lambda ts, p, k: _run_flows(*ts, spec, p, n_packets, k, horizon, dev,
                                              False),
                  points, keys, [(topo, sched)])
    return _stack_runs(runs, (len(points), keys.shape[0]))


def _scenario_count(topos: TopologyParams, scheds: EventSchedule) -> int:
    C = int(topos.route.shape[0])
    if scheds.cap_scale.dim() != 3 or int(scheds.cap_scale.shape[0]) != C:
        raise ValueError(f"{C} topologies need {C} stacked schedules, got "
                         f"{tuple(scheds.cap_scale.shape)}")
    return C


def sweep_flows_scenarios(topos: TopologyParams, scheds: EventSchedule, spec: SenderSpec,
                          sp: SenderParams, n_packets: int, keys: torch.Tensor,
                          horizon: int = 4096, *, device="cuda",
                          on_run: Callable | None = None):
    """`sweep_flows` over C stacked scenarios (`scenarios.stack_scenarios`):
    ``cct[C, P, D, F]``; scenario c runs exactly ``sweep_flows(topos[c],
    scheds[c], ...)``, and ``on_run((c, p, d), out)`` is called after each
    run."""
    points, dev = _points(sp), resolve_device(device)
    C = _scenario_count(topos, scheds)
    keys = _keys(keys, dev)
    scenarios = [(to_device(frame_select(topos, c), dev),
                  to_device(frame_select(scheds, c), dev)) for c in range(C)]
    runs = _sweep(lambda ts, p, k: _run_flows(*ts, spec, p, n_packets, k, horizon, dev,
                                              False),
                  points, keys, scenarios, on_run)
    return _stack_runs(runs, (C, len(points), keys.shape[0]))


# --------------------------------------------------------------------------
# Flow-sharded execution: the flow axis split over the ranks of a mesh.
#
# The flow axis is split into contiguous blocks, one per rank (a thread with
# a private process group, `repro_torch.ranks`); every input is replicated.
# Bit-identity with the unsharded engine is by construction, as in the
# reference:
#
#   * every per-flow random stream (each tick's `split(ka, F)`, the ECMP
#     hash draw, the spray seeds from the global flow index) is derived at
#     the real flow count F and then padded and sliced: threefry splits are
#     not prefix-stable in their count;
#   * the two per-link sums of `shared_fabric_tick` gather the flow axis
#     first and fold it over the padded route's segments, in the unsharded
#     order, so the drop and serve fractions, and through them every local
#     per-flow value, match the unsharded run bit for bit;
#   * padding flows (F not divisible by the rank count) carry 0 packets:
#     they complete at tick 0, emit nothing and add an exact +0.0 to every
#     link sum;
#   * the early-exit predicate is the all-rank AND (`RankComm.all_true`), so
#     every rank runs the unsharded chunk count.
#
# Telemetry is not supported on this path; the unsharded engine is the
# observability path.
# --------------------------------------------------------------------------

FLOW_AXIS = "flows"
_FLOW_FIELDS = ("cct", "sent_total", "dropped_total", "final_b", "received", "finished")


def flow_mesh(n_devices: int | None = None, *, device="cuda",
              timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """The ranks of the `FLOW_AXIS` that the shard_* engines split flows over.

    On the card (the default) the ranks go round the visible cards, one a
    card unless ``n_devices`` asks for more (then ranks share a card and
    talk through gloo); ``n_devices`` defaults to every visible card, and a
    device with an index (``"cuda:1"``) holds every rank.  On the CPU
    (``device="cpu"``) there are ``n_devices`` ranks, default 1.
    ``timeout`` bounds each collective's wait, in seconds."""
    dev = resolve_device(device)
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"flow_mesh needs at least one rank, got {n_devices}")
    if dev.type != "cuda":
        return Mesh((dev,) * (n_devices or 1), float(timeout))
    if dev.index is not None:
        return Mesh((dev,) * (n_devices or 1), float(timeout))
    cards = torch.cuda.device_count()
    n = cards if n_devices is None else n_devices
    return Mesh(tuple(torch.device("cuda", r % cards) for r in range(n)), float(timeout))


def _pad_flow_axis(x: torch.Tensor, F_pad: int, dim: int, fill=None) -> torch.Tensor:
    """Pad ``dim`` (the flow axis) of ``x`` up to F_pad: edge-repeat by
    default (valid link ids, keys and paths), the constant ``fill`` on
    request."""
    dim = dim % x.dim()
    pad = F_pad - int(x.shape[dim])
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    if fill is None:
        tail = x.narrow(dim, int(x.shape[dim]) - 1, 1).expand(shape)
    else:
        tail = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail], dim)


def _pad_topology(topo: TopologyParams, F_pad: int) -> TopologyParams:
    """Pad the per-flow leaves (route [..., F, n], latency [..., F, n]) up
    to F_pad flows.  Edge-repeat keeps the padded routes valid link ids;
    padded flows never emit, so their +0.0 link contributions are exact."""
    return dataclasses.replace(
        topo, route=_pad_flow_axis(topo.route, F_pad, -2),
        latency=_pad_flow_axis(topo.latency, F_pad, -2))


@dataclasses.dataclass(frozen=True)
class _FlowBlock:
    """Rank ``comm.rank``'s contiguous block of the flow axis padded from
    ``flows`` to ``padded`` flows; without ``comm``, the whole unpadded
    axis.  ``segments`` is the padded route's CSR."""

    comm: RankComm | None
    flows: int
    padded: int
    segments: LinkSegments | None

    @property
    def size(self) -> int:
        return self.padded if self.comm is None else self.padded // self.comm.size

    @property
    def lo(self) -> int:
        return 0 if self.comm is None else self.comm.rank * self.size

    @property
    def gather(self) -> Callable | None:
        if self.comm is None:
            return None
        return functools.partial(self.comm.all_gather, dim=-2)

    def local(self, x: torch.Tensor, dim: int, fill=None) -> torch.Tensor:
        """The block of ``x``, whose ``dim`` holds the F real flows: padded
        (edge or ``fill``), then sliced."""
        if self.comm is None:
            return x
        return _pad_flow_axis(x, self.padded, dim, fill).narrow(dim, self.lo, self.size)

    def local_topology(self, topo: TopologyParams) -> TopologyParams:
        """The block of the flow-padded ``topo``."""
        if self.comm is None:
            return topo
        return dataclasses.replace(topo, route=topo.route.narrow(1, self.lo, self.size),
                                   latency=topo.latency.narrow(0, self.lo, self.size))


def _stitch(parts: Sequence[SimResult], F: int, dev: torch.device) -> SimResult:
    """One run whole from its ranks' blocks: the per-flow fields
    concatenated in rank order with the padding cut off; the link
    counters and ticks, which every rank holds alike, from rank 0."""
    flow = {k: torch.cat([getattr(p, k).to(dev) for p in parts])[:F] for k in _FLOW_FIELDS}
    return dataclasses.replace(parts[0], **flow, link_served=parts[0].link_served.to(dev),
                               link_busy=parts[0].link_busy.to(dev),
                               ticks_run=parts[0].ticks_run.to(dev))


def _on_device(obj, dev: torch.device):
    """``obj`` with every tensor in it on ``dev``: a tensor, a dataclass of
    tensors, or a tuple, list or dict of them; anything else as it is."""
    if torch.is_tensor(obj):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return to_device(obj, dev)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_on_device(x, dev) for x in obj)
    if isinstance(obj, dict):
        return {k: _on_device(v, dev) for k, v in obj.items()}
    return obj


def _shard_runs(mesh: Mesh, topos: Sequence[TopologyParams], spec: SenderSpec,
                horizon: int, loop: Callable, data) -> list:
    """Run ``loop(run, data)`` on every rank of ``mesh``, one thread a rank,
    where ``run(c, sched, sp, n_packets, key)`` is the rank's block of
    ``run_flows_sized(topos[c], sched, spec, sp, n_packets, key, horizon)``
    and ``loop`` returns its runs' outputs as a list (the same runs on every
    rank, in the same order).  Returns those runs whole, on the first rank's
    device.

    Everything a rank reads is on its device before the ranks start: each
    padded topology with its segments (built once a call, on the host) and
    ``data`` (`_on_device`).  A rank that copied from another card while a
    rank there waits in an NCCL collective would wait behind that
    collective, which waits for it."""
    if spec.telemetry is not None:
        raise NotImplementedError(
            "telemetry capture is not supported on the flow-sharded path; "
            "use the unsharded engine for observability runs")
    F = topos[0].flows
    if any(t.flows != F for t in topos):
        raise ValueError("the topologies of one sharded call hold one flow count")
    F_pad = -(-F // mesh.size) * mesh.size
    devices = list(dict.fromkeys(mesh.devices))
    padded = [_pad_topology(topo, F_pad) for topo in topos]
    on = {dev: ([to_device(t, dev) for t in padded], _on_device(data, dev)) for dev in devices}
    for topos_dev, _ in on.values():
        for t in topos_dev:
            t.segments  # noqa: B018 - builds the cached CSR before the ranks start

    def body(comm: RankComm) -> list:
        topos_dev, data_dev = on[comm.device]
        blocks = [_FlowBlock(comm, F, F_pad, t.segments) for t in topos_dev]

        def run(c, sched, sp, n_packets, key):
            return _run_flows(topos_dev[c], sched, spec, sp, n_packets, key, horizon,
                              comm.device, False, blocks[c])

        return loop(run, data_dev)

    per_rank = run_ranks(mesh, body)
    return [_stitch(parts, F, mesh.devices[0]) for parts in zip(*per_rank)]


def shard_run_flows(topo: TopologyParams, sched: EventSchedule, spec: SenderSpec,
                    sp: SenderParams, n_packets, key: torch.Tensor, horizon: int = 4096, *,
                    mesh: Mesh | None = None) -> SimResult:
    """`run_flows` sharded over the flow axis on ``mesh`` (`flow_mesh`;
    default: every visible card).

    Bit-identical to the unsharded `run_flows` / `run_flows_sized` for any
    flow count (counts the ranks do not divide are padded with silent flows
    and cut back off).  ``n_packets`` may be a scalar or a per-flow [F]
    vector."""
    mesh = flow_mesh() if mesh is None else mesh
    return _shard_runs(mesh, [topo], spec, horizon,
                       lambda run, d: [run(0, d[0], sp, d[1], d[2])],
                       (sched, n_packets, torch.as_tensor(key)))[0]


def shard_sweep_flows(topo: TopologyParams, sched: EventSchedule, spec: SenderSpec,
                      sp: SenderParams, n_packets, keys: torch.Tensor, horizon: int = 4096,
                      *, mesh: Mesh | None = None) -> SimResult:
    """`sweep_flows` sharded over the flow axis: ``cct[P, D, F]``, the
    sweep's runs one after another inside every rank (the ranks stay in
    step)."""
    mesh = flow_mesh() if mesh is None else mesh
    points, keys = _points(sp), _keys(keys, "cpu")
    runs = _shard_runs(mesh, [topo], spec, horizon, lambda run, d: _sweep(
        lambda c, p, k: run(c, d[0], p, d[1], k), points, d[2], [0]), (sched, n_packets, keys))
    return _stack_runs(runs, (len(points), keys.shape[0]))


def shard_sweep_flows_scenarios(topos: TopologyParams, scheds: EventSchedule,
                                spec: SenderSpec, sp: SenderParams, n_packets,
                                keys: torch.Tensor, horizon: int = 4096, *,
                                mesh: Mesh | None = None) -> SimResult:
    """`sweep_flows_scenarios` sharded over the flow axis: ``cct[C, P, D,
    F]``, bit-identical to the unsharded family sweep."""
    mesh = flow_mesh() if mesh is None else mesh
    points, keys = _points(sp), _keys(keys, "cpu")
    C = _scenario_count(topos, scheds)
    topo_c = [frame_select(topos, c) for c in range(C)]
    sched_c = [frame_select(scheds, c) for c in range(C)]
    runs = _shard_runs(mesh, topo_c, spec, horizon, lambda run, d: _sweep(
        lambda c, p, k: run(c, d[0][c], p, d[1], k), points, d[2], range(C)),
        (sched_c, n_packets, keys))
    return _stack_runs(runs, (C, len(points), keys.shape[0]))
