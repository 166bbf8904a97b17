"""The user-facing transport API: `simulate_message`, `simulate_message_on`
and `simulate_flows` over the one sender engine in `repro_torch.net.sender`.

Entry points run on the card by default (``device="cuda"``) and raise when
there is none; pass ``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.spray import SprayMethod
from repro_torch.net.fabric import FabricParams
from repro_torch.net.policies import blocks_for
from repro_torch.net.sender import (Policy, SenderParams, SenderSpec, SimResult,
                                    run_flows, run_message, run_message_on,
                                    sender_params)
from repro_torch.net.topology import EventSchedule, TopologyParams

__all__ = ["Policy", "TransportConfig", "simulate_message", "simulate_message_on",
           "simulate_flows", "SimResult"]


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    policy: Policy
    coded: bool = True
    code_overhead: float = 0.05
    rate: int = 32
    ell: int = 10
    ctrl_interval: int = 4
    method: SprayMethod = SprayMethod.SHUFFLE_1
    seed: Tuple[int, int] = (333, 735)
    cwnd: float = 256.0
    early_exit: bool = False

    def __post_init__(self):
        m = 1 << self.ell
        sa, sb = self.seed
        if not (0 <= sa < m):
            raise ValueError(f"sa must be in [0, m={m}), got {sa}")
        if not (1 <= sb < m) or sb % 2 == 0:
            raise ValueError(f"sb must be odd in [1, m={m}), got {sb}")

    def spec(self) -> SenderSpec:
        return SenderSpec(coded=self.coded, ell=self.ell, method=self.method,
                          rate_cap=self.rate, early_exit=self.early_exit,
                          state_blocks=blocks_for((self.policy,)))

    def params(self) -> SenderParams:
        return sender_params(self.policy, rate=self.rate, cwnd=self.cwnd,
                             code_overhead=self.code_overhead,
                             ctrl_interval=self.ctrl_interval, seed=self.seed)


def simulate_message_on(fabric0, stepper, latency: torch.Tensor, cfg: TransportConfig,
                        n_packets: int, key: torch.Tensor, horizon: int = 4096, *,
                        mole_size: int, received_fn=None, dropped_fn=None) -> SimResult:
    """One message over an arbitrary fabric stepper (see
    `sender.run_message_on` for its contract); runs where `latency` lies."""
    return run_message_on(fabric0, stepper, latency, cfg.spec(), cfg.params(),
                          n_packets, key, horizon, mole_size=mole_size,
                          received_fn=received_fn, dropped_fn=dropped_fn)


def simulate_message(params: FabricParams, cfg: TransportConfig, n_packets: int,
                     key: torch.Tensor, horizon: int = 4096, *,
                     device="cuda") -> SimResult:
    """One message on the independent-bundle fabric."""
    return run_message(params, cfg.spec(), cfg.params(), n_packets, key, horizon,
                       device=device)


def simulate_flows(topo: TopologyParams, sched: EventSchedule, cfg: TransportConfig,
                   n_packets: int, key: torch.Tensor, horizon: int = 4096, *,
                   device="cuda", plain_spray: bool = False) -> SimResult:
    """F coupled flows, one n_packets message each, on one shared fabric.
    ``plain_spray`` is for tests: it holds the WAM kernel to its plain
    version on the card."""
    return run_flows(topo, sched, cfg.spec(), cfg.params(), n_packets, key, horizon,
                     device=device, plain_spray=plain_spray)
