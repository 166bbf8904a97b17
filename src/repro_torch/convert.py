"""Carry the JAX package's parameters across to the port.

The reference's parameter objects are handed over as dicts of numpy
arrays plus their static ints (the tests extract them), so this module
never sees a JAX type.  A JAX PRNG key is a ``uint32[2]`` array.  A model's
parameter or cache tree is a nested dict of numpy arrays (bfloat16 arrays
included, recognised by their dtype's name).  Topologies and schedules may
be stacked on leading sweep axes (`scenarios.stack_scenarios`), and so
may telemetry frames.  Optimizer and training states (the reference's
NamedTuples and dataclass, with numpy leaves) are read by their field
names.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.net.fabric import FabricParams
from repro_torch.net.sender import SenderParams
from repro_torch.net.telemetry import TelemetryFrame
from repro_torch.net.topology import EventSchedule, TopologyParams
from repro_torch.optim.adafactor import AdafactorState
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.state import TrainState

__all__ = ["fabric_params", "topology_params", "event_schedule", "sender_params",
           "telemetry_frame", "prng_key", "model_params", "model_cache", "adamw_state",
           "adafactor_state", "train_state"]


def _tensors(arrays: Mapping[str, np.ndarray], names, device):
    return {k: torch.as_tensor(np.array(arrays[k]), device=device) for k in names}


def fabric_params(arrays: Mapping[str, np.ndarray], *, fb_delay: int,
                  ring_len: int, device=None) -> FabricParams:
    names = ("capacity", "latency", "queue_limit", "ecn_threshold", "degrade_p",
             "recover_p", "degrade_factor")
    return FabricParams(**_tensors(arrays, names, device), fb_delay=int(fb_delay),
                        ring_len=int(ring_len))


def topology_params(arrays: Mapping[str, np.ndarray], *, fb_delay: int,
                    ring_len: int, device=None) -> TopologyParams:
    names = ("route", "capacity", "queue_limit", "ecn_threshold", "latency",
             "degrade_p", "recover_p", "degrade_factor")
    return TopologyParams(**_tensors(arrays, names, device), fb_delay=int(fb_delay),
                          ring_len=int(ring_len))


def event_schedule(arrays: Mapping[str, np.ndarray], device=None) -> EventSchedule:
    return EventSchedule(**_tensors(arrays, ("cap_scale", "bg_arrivals"), device))


def sender_params(arrays: Mapping[str, np.ndarray]) -> SenderParams:
    """Scalar sender knobs (policy, rate, cwnd, code_overhead,
    ctrl_interval, sa, sb) as concrete Python values."""
    as_int = ("policy", "rate", "ctrl_interval", "sa", "sb")
    return SenderParams(**{k: (int(np.asarray(v)) if k in as_int
                               else float(np.asarray(v)))
                           for k, v in arrays.items()})


def telemetry_frame(arrays: Mapping[str, np.ndarray], device=None) -> TelemetryFrame:
    """A reference frame (any leading sweep axes) leaf for leaf; the uint32
    spray counter `prev_j` becomes the port's int64 of the same value."""
    out = {k: torch.as_tensor(np.array(v), device=device) for k, v in arrays.items()}
    out["prev_j"] = torch.as_tensor(np.asarray(arrays["prev_j"]).astype(np.int64),
                                    device=device)
    return TelemetryFrame(**out)


def prng_key(key: np.ndarray, device=None) -> torch.Tensor:
    """A legacy ``uint32[2]`` key (or a ``[..., 2]`` stack of them) as the
    port's int64 key tensor."""
    key = np.asarray(key)
    if key.ndim < 1 or key.shape[-1] != 2 or key.dtype != np.uint32:
        raise ValueError(f"expected uint32[..., 2] keys, got {key.dtype}{key.shape}")
    return torch.as_tensor(key.astype(np.int64), device=device)


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # no numpy dtype in torch: carry the bits
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def _tree(tree, device):
    if isinstance(tree, Mapping):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def model_params(tree: Mapping, device=None) -> dict:
    """The reference's model parameter tree (``init_params``; nested dicts
    of numpy arrays, period leaves stacked on a leading axis; the encoder,
    the projector, MoE routers and experts included) as the port's tree of
    tensors, leaf for leaf and in the same dtypes."""
    return _tree(tree, device)


def model_cache(tree: Mapping, device=None) -> dict:
    """The reference's decode cache tree (``make_cache`` / ``prefill``) as
    the port's, leaf for leaf: bf16 KV entries keep their bits, int8 ones
    their f32 scales; Mamba, mLSTM and sLSTM states in their dtypes."""
    return _tree(tree, device)


def adamw_state(state, device=None) -> AdamWState:
    """The reference's ``AdamWState`` (numpy leaves) as the port's: the
    int32 step and the f32 moment trees ``m``, ``v``."""
    return AdamWState(step=_leaf(state.step, device), m=_tree(state.m, device),
                      v=_tree(state.v, device))


def adafactor_state(state, device=None) -> AdafactorState:
    """The reference's ``AdafactorState`` (numpy leaves) as the port's: the
    int32 step, the row moments ``vr`` and the column moments ``vc``."""
    return AdafactorState(step=_leaf(state.step, device), vr=_tree(state.vr, device),
                          vc=_tree(state.vc, device))


def train_state(state, device=None) -> TrainState:
    """The reference's ``TrainState`` (numpy leaves; AdamW or Adafactor
    state, told apart by its fields) as the port's."""
    opt = state.opt_state
    opt = adamw_state(opt, device) if hasattr(opt, "m") else adafactor_state(opt, device)
    return TrainState(params=model_params(state.params, device), opt_state=opt,
                      step=_leaf(state.step, device))
