"""AdamW with global-norm clipping: the port of the JAX package's
`optim/adamw.py`, in its order of operations (f32 throughout, leaves in
the reference's flattening order).

The update writes the new moments and parameters into the state's and
the parameters' own tensors (an update in place: at full width the
functional form would hold two copies of params, m and v at once) and
returns them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import tree

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    m: Any
    v: Any


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's order) of each
    leaf's f32 sum of squares."""
    return torch.stack([torch.sum(torch.square(g.float())) for g in tree.leaves(grads)]
                       ).sum().sqrt()


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    step = torch.zeros((), dtype=torch.int32, device=tree.leaves(params)[0].device)
    return AdamWState(step=step, m=tree.map_leaves(zeros, params),
                      v=tree.map_leaves(zeros, params))


def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig, lr_scale=1.0):
    """(params', state'): params, m and v updated in place."""
    step = state.step + 1
    scale = None
    if cfg.clip_norm is not None:
        norm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(norm, min=1e-9), max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    t = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)
    lr = cfg.lr * lr_scale
    for p, mm, vv, g in zip(tree.leaves(params), tree.leaves(state.m), tree.leaves(state.v),
                            tree.leaves(grads)):
        g = g.float() if scale is None else g.float() * scale  # one leaf at a time
        mm.copy_(b1 * mm + (1 - b1) * g)
        vv.copy_(b2 * vv + (1 - b2) * g * g)
        u = (mm / bc1) / (torch.sqrt(vv / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
    return params, AdamWState(step=step, m=state.m, v=state.v)
