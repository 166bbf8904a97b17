"""The flow-batched sender engine: one tick core for every entry point.

`run_sender` holds the paper's sender semantics (emit budget, spraying,
retransmission debt, the delayed-feedback profile controller, completion
detection) as a Python loop over ticks.  `run_message` / `run_message_on`
are its single-flow form and `run_flows` / `run_flows_sized` its F-flow
form on the shared leaf-spine fabric.  The policy is a concrete id, so
each run executes only its own branch; the WAM branch launches the
`spray_select` kernel once per tick for all flows.

Random numbers follow the reference's key streams exactly: the per-tick
keys are split from one loop key up front (`tick_keys`), and each chunk of
ticks draws its mole uniforms and per-lane integers in one batched call.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import torch

from repro_torch import random as prng
from repro_torch.core.feedback import (ControllerState, PathStats, controller_step,
                                       make_controller)
from repro_torch.core.profile import make_profile, uniform_profile
from repro_torch.core.spray import SprayMethod, SprayState
from repro_torch.device import resolve_device
from repro_torch.net.fabric import FabricParams, fabric_tick, init_fabric
from repro_torch.net.policies import (ALL_POLICIES, BASELINE_POLICIES, Policy,
                                      assign_lanes, blocks_for, profile_adaptive,
                                      uses_rng)
from repro_torch.net.policy_state import (PolicyState, init_policy_state,
                                          update_policy_state)
from repro_torch.net.topology import (EventSchedule, TopologyParams,
                                      init_shared_fabric, shared_fabric_tick)
from repro_torch.numerics import fold_sum
from repro_torch.random import M32

__all__ = ["Policy", "BASELINE_POLICIES", "ALL_POLICIES", "SenderSpec",
           "SenderParams", "SimResult", "sender_params", "spec_for_policies",
           "completion_need", "assign_paths", "tick_keys", "fabric_quiescent",
           "run_sender", "run_message_on", "run_message", "run_flows",
           "run_flows_sized", "resolve_device", "to_device"]


@dataclasses.dataclass(frozen=True)
class SenderSpec:
    """Shape-affecting sender description (see `repro.net.sender`)."""

    coded: bool = True
    ell: int = 10
    method: SprayMethod = SprayMethod.SHUFFLE_1
    rate_cap: int = 32
    early_exit: bool = False
    exit_chunk: int = 64
    telemetry: object | None = None
    state_blocks: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class SenderParams:
    """Sender knobs as concrete Python values (the policy picks a branch)."""

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
    link_served: torch.Tensor    # float32[L] or [0]
    link_busy: torch.Tensor      # float32[L] or [0]
    ticks_run: int = 0           # ticks executed (fewer than the horizon
                                 # when early exit skipped settled ones)


def to_device(obj, device):
    """A copy of a dataclass of tensors with every tensor on `device`."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def completion_need(n_packets, coded: bool, code_overhead: float,
                    device=None) -> torch.Tensor:
    """Arrivals a flow needs, less a 0.25 float-residue guard: K(1+eps)
    distinct packets (floor, +1) when coded, all K otherwise; messages of
    at most 4 packets waive the overhead."""
    npk = torch.as_tensor(n_packets, device=device).to(torch.float32)
    if coded:
        overhead = npk * torch.tensor(code_overhead, dtype=torch.float32, device=device)
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


def _settled(spec: SenderSpec, c: _Carry) -> bool:
    """Every flow done, ARQ debt drained, fabric quiescent (absorbing)."""
    done = (c.done_at >= 0).all() & fabric_quiescent(c.fabric)
    if not spec.coded:
        done = done & (c.debt == 0).all()
    return bool(done)


def run_sender(spec: SenderSpec, sp: SenderParams, n_packets, horizon: int, *,
               n: int, fabric0, stepper: Callable, mole_size: int,
               latency_f: torch.Tensor, spray0: SprayState, ctrl0: ControllerState,
               ecmp_path: torch.Tensor, flow_keys: bool, received_fn: Callable,
               dropped_fn: Callable, k_loop: torch.Tensor,
               link_fn: Callable | None = None,
               plain_spray: bool = False) -> SimResult:
    """The sender tick core over F flows (F = 1 for one message).

    stepper(fabric, arrivals[F, n], u[mole_size]) -> (fabric', fb) is the
    fabric.  ``flow_keys`` splits each tick's lane key into one key per
    flow (the coupled-flow engine) instead of using it as is.
    ``plain_spray`` sends the WAM branch through the kernel's plain version
    even on the card; it exists so a test can hold the kernel to it."""
    if spec.telemetry is not None:
        raise NotImplementedError("telemetry is not ported yet")
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
    cwnd = torch.tensor(sp.cwnd, dtype=torch.float32, device=dev)
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
        if not spec.coded:
            fb_dropped = fold_sum(fb["dropped"])
            unsent = torch.clamp_min(npk - c.sent_sched, 0.0)
            debt = (c.debt + fb_dropped) - torch.clamp_min(k_emit - unsent, 0.0)
            debt = torch.clamp_min(debt, 0.0)
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

    def run(c: _Carry, keys: torch.Tensor) -> _Carry:
        """Run one tick per row of keys [T, 2, 2], drawing the chunk's
        random numbers in one batched call."""
        u = prng.uniform(keys[:, 1], (mole_size,))
        lanes = None
        if rng_hi is not None:
            ka = prng.split(keys[:, 0], F) if flow_keys else keys[:, 0].unsqueeze(1)
            lanes = prng.randint(ka, (spec.rate_cap,), 0, rng_hi)
        for i in range(keys.shape[0]):
            c = tick(c, u[i], None if lanes is None else lanes[i])
        return c

    done_at0 = torch.where(need <= 0.0, 0, -1).to(torch.int32).expand(lead).clone()
    carry = _Carry(fabric0, ctrl0, spray0, zeros, zeros, done_at0,
                   torch.zeros(lead + (n,), device=dev), zeros, zeros, pstate0)
    chunk = max(1, min(spec.exit_chunk, horizon))
    n_full, rem = divmod(horizon, chunk)
    i = 0
    while i < n_full and not (spec.early_exit and _settled(spec, carry)):
        carry = run(carry, tkeys[i * chunk:(i + 1) * chunk])
        i += 1
    if rem:
        carry = run(carry, tkeys[n_full * chunk:])
    ticks_run = i * chunk + rem

    done_at = carry.done_at
    cct = torch.where(done_at >= 0, done_at.to(torch.float32),
                      torch.tensor(float(horizon), device=dev))
    if link_fn is not None:
        link_served, link_busy = link_fn(carry.fabric)
    else:
        link_served = link_busy = torch.zeros((0,), device=dev)
    return SimResult(cct=cct, sent_total=carry.sent_pp,
                     dropped_total=dropped_fn(carry.fabric),
                     final_b=carry.ctrl.profile.b, received=received_fn(carry.fabric),
                     finished=done_at >= 0, link_served=link_served,
                     link_busy=link_busy, ticks_run=ticks_run)


def _squeeze_flow(r: SimResult) -> SimResult:
    return dataclasses.replace(r, **{
        k: getattr(r, k)[0] for k in ("cct", "sent_total", "dropped_total",
                                      "final_b", "received", "finished")})


def run_message_on(fabric0, stepper, latency: torch.Tensor, spec: SenderSpec,
                   sp: SenderParams, n_packets: int, key: torch.Tensor,
                   horizon: int = 4096, *, mole_size: int, received_fn=None,
                   dropped_fn=None) -> SimResult:
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
                   spray0=spray0, ctrl0=ctrl0, ecmp_path=ecmp, flow_keys=False,
                   received_fn=received_fn, dropped_fn=dropped_fn, k_loop=keys[1])
    return _squeeze_flow(r)


def run_message(params: FabricParams, spec: SenderSpec, sp: SenderParams,
                n_packets: int, key: torch.Tensor, horizon: int = 4096, *,
                device="cuda") -> SimResult:
    """One message on the independent-bundle fabric."""
    dev = resolve_device(device)
    params = to_device(params, dev)

    def stepper(state, arrivals, u):
        return fabric_tick(params, state, arrivals, u)

    return run_message_on(init_fabric(params, (1,)), stepper, params.latency, spec,
                          sp, n_packets, key, horizon, mole_size=params.n)


def _run_flows(topo: TopologyParams, sched: EventSchedule, spec: SenderSpec,
               sp: SenderParams, n_packets, key: torch.Tensor, horizon: int,
               device, plain_spray: bool) -> SimResult:
    dev = resolve_device(device)
    topo, sched = to_device(topo, dev), to_device(sched, dev)
    F, n = topo.flows, topo.n
    mask = (1 << spec.ell) - 1
    fidx = torch.arange(F, dtype=torch.int64, device=dev)
    prof = uniform_profile(n, spec.ell, device=dev)
    ctrl0 = make_controller(make_profile(prof.b.expand(F, n), spec.ell))
    spray0 = SprayState(
        j=torch.zeros(F, dtype=torch.int64, device=dev),
        sa=(sp.sa + fidx * 0x9E3779B9) & mask,
        sb=((sp.sb + 2 * fidx) & mask) | 1,
        ell=spec.ell, method=int(spec.method))
    keys = prng.split(key.to(dev), 2)
    ecmp = prng.randint(keys[0], (F,), 0, n)
    if torch.is_tensor(n_packets):
        n_packets = n_packets.to(dev)

    def stepper(state, arrivals, u):
        return shared_fabric_tick(topo, sched, state, arrivals, u)

    return run_sender(
        spec, sp, n_packets, horizon, n=n, fabric0=init_shared_fabric(topo),
        stepper=stepper, mole_size=topo.links,
        latency_f=topo.latency.to(torch.float32), spray0=spray0, ctrl0=ctrl0,
        ecmp_path=ecmp, flow_keys=True, received_fn=lambda s: s.received,
        dropped_fn=lambda s: s.dropped, k_loop=keys[1],
        link_fn=lambda s: (s.link_served, s.link_busy), plain_spray=plain_spray)


def run_flows(topo: TopologyParams, sched: EventSchedule, spec: SenderSpec,
              sp: SenderParams, n_packets: int, key: torch.Tensor,
              horizon: int = 4096, *, device="cuda",
              plain_spray: bool = False) -> SimResult:
    """F coupled flows, one n_packets message each, on one shared fabric;
    flow f sprays with seed (sa + f * 0x9E3779B9, sb + 2f)."""
    return _run_flows(topo, sched, spec, sp, n_packets, key, horizon, device,
                      plain_spray)


def run_flows_sized(topo: TopologyParams, sched: EventSchedule, spec: SenderSpec,
                    sp: SenderParams, n_packets, key: torch.Tensor,
                    horizon: int = 4096, *, device="cuda") -> SimResult:
    """`run_flows` with a per-flow message size (int or int tensor [F]);
    size-0 flows complete at tick 0."""
    return _run_flows(topo, sched, spec, sp, n_packets, key, horizon, device, False)
