"""Adafactor (factored second moments): the port of the JAX package's
`optim/adafactor.py` (Shazeer & Stern 2018), in its order of operations.

A leaf whose last two dims are both at least 128 keeps row and column
second moments (``vr`` drops the last dim, ``vc`` the one before);
every other leaf keeps a full ``vr`` and a placeholder ``vc`` of one
zero.  The update is clipped to an RMS of ``clip_threshold``, weight
decay is decoupled, and a bf16 parameter (the MoE giants') is updated in
f32 and rounded back.  As `adamw`, the update writes into the state's and
the parameters' own tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import tree

__all__ = ["AdafactorConfig", "AdafactorState", "adafactor_init", "adafactor_update"]


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8          # beta2_t = 1 - step^-decay
    eps1: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    min_dim_factored: int = 128


class AdafactorState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    vr: Any  # row second moments (or the full v of an unfactored leaf)
    vc: Any  # column second moments (a one-zero placeholder when unfactored)


def _factored(p) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= 128 and p.shape[-2] >= 128


def adafactor_init(params) -> AdafactorState:
    def vr_init(p):
        shape = p.shape[:-1] if _factored(p) else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vc_init(p):
        shape = (*p.shape[:-2], p.shape[-1]) if _factored(p) else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    step = torch.zeros((), dtype=torch.int32, device=tree.leaves(params)[0].device)
    return AdafactorState(step=step, vr=tree.map_leaves(vr_init, params),
                          vc=tree.map_leaves(vc_init, params))


def adafactor_update(grads, state: AdafactorState, params, cfg: AdafactorConfig,
                     lr_scale=1.0):
    """(params', state'): params, vr and vc updated in place."""
    step = state.step + 1
    t = step.float()
    beta2 = 1.0 - t ** (-cfg.decay)
    lr = cfg.lr * lr_scale
    eps1 = cfg.eps1
    for p, g, vr, vc in zip(tree.leaves(params), tree.leaves(grads), tree.leaves(state.vr),
                            tree.leaves(state.vc)):
        g = g.float()
        g2 = g * g + eps1
        if _factored(p):
            vr.copy_(beta2 * vr + (1 - beta2) * g2.mean(dim=-1))
            vc.copy_(beta2 * vc + (1 - beta2) * g2.mean(dim=-2))
            r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps1)
            u = g * torch.rsqrt(r)[..., None] * torch.rsqrt(torch.clamp(vc, min=eps1))[..., None, :]
        else:
            vr.copy_(beta2 * vr + (1 - beta2) * g2)
            u = g * torch.rsqrt(torch.clamp(vr, min=eps1))
        # update-RMS clipping
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        p.copy_((p.float() - lr * (u + cfg.weight_decay * p.float())).to(p.dtype))
    return params, AdafactorState(step=step, vr=state.vr, vc=state.vc)
