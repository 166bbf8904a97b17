"""Mixture-of-Experts layer: the port of the JAX package's `models/moe.py`.

Token-choice top-k routing with capacity: tokens pick their top-k experts,
each expert accepts its top-C tokens by gate (``C = min(max(ceil(T k cf /
E), 8), T)``), the accepted tokens are gathered per expert, transformed,
weighted by their gate and added back; overflow tokens are dropped (the
residual stream carries them).  One group of tokens (the reference's
``batch_shard_count()`` is 1 on one card).  Returns ``(y, aux)`` with the
Switch-style load-balance loss.

Ties.  ``lax.top_k`` puts the lower index first among equal values; a
stable descending sort does the same, and takes the first k (or C).

The combine.  The reference scatter-adds the gated expert rows into a bf16
buffer one row at a time in (expert, slot) order, rounding after each add.
An expert holds a token at most once, and a row whose gate is 0 adds a
zero, so a token's sum is the fold of its accepted experts' rows in
ascending expert order.  The port gathers those rows ``[T, k, D]`` and
folds them in that order, rounding each add to bf16: the same sum on the
CPU and on the card, with no atomics (a scatter-add with atomics on the
card would not equal itself from run to run).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import COMPUTE_DTYPE, _normal, gelu, matmul, silu

__all__ = ["init_moe", "moe", "capacity", "Routes"]


def _cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


def init_moe(generator: torch.Generator, cfg: ArchConfig, device, stack: tuple = ()) -> dict:
    """Router (f32, as the reference keeps it) and expert weights, each with
    the leading dims ``stack``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    dt = getattr(torch, cfg.param_dtype)
    std = float(1.0 / np.sqrt(d))
    p = {
        "router": _normal((*stack, d, e), generator, std, torch.float32, device),
        "w_up": _normal((*stack, e, d, f), generator, std, dt, device),
        "w_down": _normal((*stack, e, f, d), generator, float(std / np.sqrt(cfg.n_layers)), dt,
                          device),
    }
    if cfg.mlp_kind == "swiglu":
        p["w_gate"] = _normal((*stack, e, d, f), generator, std, dt, device)
    return p


def capacity(cfg: ArchConfig, tokens: int) -> int:
    """Tokens an expert accepts: ``ceil(T k cf / E)``, at least 8 and at
    most T."""
    c = int(np.ceil(tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.moe_experts))
    return min(max(c, 8), tokens)


def _top(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (``lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


class Routes:
    """A run's routing choices, so that a second run can be held to the
    first with the same discrete choices (as teacher forcing feeds it the
    same tokens): a near-tie between two experts' gates otherwise flips
    with the last bit of the hidden state, and moves that token's output by
    a whole expert.  The first run records each MoE call's choices in
    order; `replay` rewinds, and the second run (on any device) then takes
    the recorded choices with its own gates, and counts the calls' choices
    that differ from its own (`flips`, out of `choices`).

    Training recomputes a sublayer's forward in its backward (remat), so
    there a call names its site (`begin_pass` counts the forward passes,
    the stack names the period and sublayer): a site's first call records
    or replays, and a recomputation takes what the site holds."""

    def __init__(self):
        self.calls: list = []
        self.sites: dict = {}
        self.replaying = False
        self.flips = self.choices = 0
        self._next = 0
        self._pass = -1
        self._seen: set = set()

    def replay(self) -> "Routes":
        self.replaying, self._next, self.flips, self.choices = True, 0, 0, 0
        self._pass = -1
        self._seen = set()
        return self

    def begin_pass(self) -> None:
        """A new forward pass (a training step's loss, or a microbatch's)."""
        self._pass += 1

    def _count(self, own: torch.Tensor, chosen: torch.Tensor) -> None:
        # a device count: read once the run ends, so that no call waits
        differ = (own.sort(dim=-1).values != chosen.sort(dim=-1).values).any(-1)
        self.flips = self.flips + differ.sum()
        self.choices += own.shape[0]

    def take(self, own: torch.Tensor, site=None) -> torch.Tensor:
        """The choice (indices) of this call: ``own``, recorded, or the
        recorded one when replaying; by ``site`` when one is named."""
        if site is not None:
            key = (self._pass, *site)
            if not self.replaying:
                return self.sites.setdefault(key, own)
            chosen = self.sites[key].to(own.device)
            if key not in self._seen:
                self._seen.add(key)
                self._count(own, chosen)
            return chosen
        if not self.replaying:
            self.calls.append(own)
            return own
        chosen = self.calls[self._next].to(own.device)
        self._next += 1
        self._count(own, chosen)
        return chosen


def moe(p: dict, cfg: ArchConfig, x: torch.Tensor, routes: Routes | None = None, site=None):
    """x: [B, S, D] bf16 -> (y [B, S, D] bf16, aux f32 scalar).  ``routes``
    records or replays the tokens' expert choices and the experts' token
    choices (`Routes`), at ``site`` when the caller names one (training)."""
    B, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, D)
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)   # [T, E]
    top_w, top_ids = _top(probs, K)                                    # [T, K]
    if routes is not None:
        top_ids = routes.take(top_ids, None if site is None else (*site, "tokens"))
        top_w = probs.gather(1, top_ids)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    tok_gate = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    tok_gate.scatter_(1, top_ids, top_w)                               # [T, E]

    # Switch-style load-balance aux loss
    chosen = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    chosen.scatter_(1, top_ids, 1.0)
    aux = E * (chosen.mean(dim=0) * probs.mean(dim=0)).sum()

    # expert-side capacity: each expert's top-C tokens by gate
    C = capacity(cfg, T)
    gate_ec, idx_ec = _top(tok_gate.T, C)                              # [E, C]
    if routes is not None:
        idx_ec = routes.take(idx_ec, None if site is None else (*site, "experts"))
        gate_ec = tok_gate.T.gather(1, idx_ec)
    gate_ec = torch.where(gate_ec > 0, gate_ec, 0.0)

    # gathers by `F.embedding`: its gradient sums in order (`model._embed_tokens`)
    xe = F.embedding(idx_ec, xt)                                       # [E, C, D]
    if "w_gate" in p:
        h = silu(matmul(xe, _cast(p["w_gate"]))) * matmul(xe, _cast(p["w_up"]))
    else:
        h = gelu(matmul(xe, _cast(p["w_up"])))
    ye = matmul(h, _cast(p["w_down"]))                                 # [E, C, D]
    ye = ye * gate_ec[..., None].to(ye.dtype)

    # each token's slot in each expert's list, -1 where it was not taken
    slot = torch.full((E, T), -1, dtype=torch.int64, device=x.device)
    slot.scatter_(1, idx_ec, torch.arange(C, device=x.device).expand(E, C).contiguous())
    experts = top_ids.sort(dim=-1).values                              # [T, K] ascending
    taken = slot.gather(0, experts.T).T                                # [T, K]
    rows = torch.where(taken >= 0, experts * C + taken, E * C)         # E * C: a zero row
    ye_flat = torch.cat([ye.reshape(E * C, D), ye.new_zeros((1, D))])
    parts = F.embedding(rows, ye_flat)                                 # [T, K, D]
    y = parts[:, 0]
    for j in range(1, K):
        y = y + parts[:, j]
    return y.reshape(B, S, D), aux
