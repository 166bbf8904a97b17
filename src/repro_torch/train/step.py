"""Step builders: the port of the JAX package's `train/step.py`.

`build_train_step` is loss -> gradient -> optimizer update, with optional
microbatch gradient accumulation (in the parameters' dtype, as the
reference's) and a pluggable learning-rate schedule.  The reference's
`build_sprayed_dp_step` (manual data parallelism with sprayed gradient
reduction over `repro.dist`, which the tree does not hold) is not ported.

The serving steps return the greedy next token (argmax, the first index
on ties, as `jnp.argmax`), the updated cache and, beside them, the step's
logits, so that a caller can hold two runs to each other.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.optim.api import Optimizer, cosine_schedule
from repro_torch.train.state import TrainState

__all__ = ["greedy", "build_train_step", "build_prefill_step", "build_decode_step"]


def _compute_copy(params):
    """Every f32 leaf cast to bf16 (the reference's ``cast_compute``: the
    embedding, head, norms and routers too, not only the leaves serving's
    `compute_params` casts); other leaves as they are."""
    return tree.map_leaves(lambda p: p.to(torch.bfloat16) if p.dtype == torch.float32 else p,
                           params)


def build_train_step(cfg: ArchConfig, optimizer: Optimizer, *, microbatch: Optional[int] = None,
                     remat: bool = True, remat_policy=None,
                     schedule: Callable = cosine_schedule, cast_compute: bool = True,
                     plain: bool = False, routes=None):
    """Returns ``train_step(state, batch) -> (state', metrics)``, metrics
    ``loss``, ``ce``, ``moe_aux`` and ``lr_scale`` (0-d tensors on the
    device).  The optimizer updates the state's tensors in place.

    The step is the composition of two functions it carries as attributes,
    so that a caller can read the gradients between them:
    ``train_step.grads(params, batch) -> (loss, metrics, grads)`` (grads a
    tree like params) and ``train_step.apply(state, loss, metrics, grads)
    -> (state', metrics)``.  ``cast_compute`` casts every f32 leaf to bf16
    at step entry, as the reference does; ``remat_policy`` (None or
    ``"save_ffn"``) is `models.model.train_loss`'s; ``plain`` runs the attention
    kernels' plain versions; ``routes`` records or replays the MoE choices
    (`moe.Routes`).  The reference's ``unroll`` is an XLA compile knob with
    no counterpart here."""

    def loss_fn(params, batch):
        if cast_compute:
            params = _compute_copy(params)
        return M.train_loss(params, cfg, batch, remat=remat, remat_policy=remat_policy,
                            plain=plain, routes=routes)

    def value_and_grad(params, batch):
        leaves = tree.map_leaves(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = loss_fn(leaves, batch)
        it = iter(torch.autograd.grad(loss, tree.leaves(leaves)))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree.map_leaves(lambda _: next(it), params))

    def grads_of(params, batch: Dict):
        if microbatch is None or microbatch <= 1:
            return value_and_grad(params, batch)
        # gradient accumulation over microbatches (leading-dim split), in the
        # PARAM dtype, as the reference accumulates
        for v in batch.values():
            if v.shape[0] % microbatch:
                raise ValueError(f"batch of {v.shape[0]} does not split into {microbatch}")
        parts = [{k: v.chunk(microbatch, dim=0)[i] for k, v in batch.items()}
                 for i in range(microbatch)]
        loss_sum = torch.zeros((), dtype=torch.float32, device=tree.leaves(params)[0].device)
        grads = tree.map_leaves(torch.zeros_like, params)
        for part in parts:
            loss, metrics, g = value_and_grad(params, part)
            grads = tree.map_leaves(torch.add, grads, g)
            loss_sum = loss_sum + loss
        scale = 1.0 / microbatch
        return loss_sum * scale, metrics, tree.map_leaves(lambda g: g * scale, grads)

    def apply(state: TrainState, loss, metrics, grads):
        lr_scale = schedule(state.step)
        new_params, new_opt = optimizer.update(grads, state.opt_state, state.params, lr_scale)
        new_state = TrainState(params=new_params, opt_state=new_opt, step=state.step + 1)
        return new_state, {"loss": loss, **metrics, "lr_scale": lr_scale}

    def train_step(state: TrainState, batch: Dict):
        return apply(state, *grads_of(state.params, batch))

    train_step.grads = grads_of
    train_step.apply = apply
    return train_step


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def build_prefill_step(cfg: ArchConfig, *, plain: bool = False, routes=None):
    """prefill(params, batch, cache) -> (next int32[B], cache, logits f32[B, V]).
    ``batch`` holds ``tokens`` and the frontend's ``patches`` or ``frames``
    (`models.model.prefill`); ``routes`` records or replays the MoE choices."""

    def prefill_step(params, batch, cache):
        logits, cache = M.prefill(params, cfg, batch, cache, plain=plain, routes=routes)
        return greedy(logits), cache, logits

    return prefill_step


def build_decode_step(cfg: ArchConfig, *, plain: bool = False, routes=None):
    """decode(params, tokens [B, 1], pos [B], cache) -> (next int32[B], cache,
    logits f32[B, V])."""

    def decode_step(params, tokens, pos, cache):
        logits, cache = M.decode_step(params, cfg, tokens, pos, cache, plain=plain,
                                      routes=routes)
        return greedy(logits), cache, logits

    return decode_step
