"""The training state: parameters, optimizer state and the step count
(the JAX package's `train/state.py`)."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["TrainState"]


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor  # int32, 0-d, on the parameters' device

    @staticmethod
    def create(params, opt_state) -> "TrainState":
        return TrainState(params=params, opt_state=opt_state,
                          step=torch.zeros((), dtype=torch.int32, device=opt_state.step.device))
