"""Whack-a-Mole: each packet's path is the count of cumulative profile
entries at or below the bit-reversed spray key of the flow's packet
counter, and the paper's delayed-feedback controller moves the profile's
balls off degraded paths every ``ctrl_interval`` ticks."""
from __future__ import annotations

import torch

from wambench.reference.threefry import M32

CONTROLLER = True


def start(ctx) -> dict:
    b = ctx.b0
    return dict(b=b, c=cumulative(b), r=torch.zeros(ctx.F, dtype=torch.int32, device=b.device),
                ewma=torch.zeros(ctx.F, ctx.n, device=b.device))


def paths(ctx, st: dict, j):
    return wam_paths(j, st["c"], ctx.sa_f, ctx.sb_f, ctx.lanes, ctx.ell, ctx.method)


def feedback(ctx, st: dict, t: int, ecn, loss, rtt) -> dict:
    if t % ctx.ctrl_interval:
        return st
    b, r, w = controller_step(st["b"], st["r"], st["ewma"], ecn, loss, rtt, ctx.m)
    return dict(b=b, c=cumulative(b), r=r, ewma=w)


def profile(st: dict):
    return st["b"]


# -------------------------------------------------------------------- spray

def _bitrev32(x):
    for s, m in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F), (8, 0x00FF00FF)):
        x = ((x >> s) & m) | ((x & m) << s)
    return ((x >> 16) | (x << 16)) & M32


def theta(j, ell):
    return _bitrev32(j & ((1 << ell) - 1)) >> (32 - ell)


def _mul32(a, b):
    lo, hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def spray_key(j, sa, sb, ell, method):
    mask = (1 << ell) - 1
    j, sa, sb = j & M32, sa & M32, sb & M32
    if method == "PLAIN":
        return theta(j, ell)
    if method == "SHUFFLE_1":
        return theta((sa + (j & mask) * (sb & mask)) & mask, ell)
    if method == "SHUFFLE_2":
        return ((sa & mask) + (sb & mask) * theta(j, ell)) & mask
    if method == "COMBINED":
        inner = theta((sa + (j & mask) * (sb & mask)) & mask, ell)
        return (theta(sa, ell) + ((_mul32(sb, 0x9E37) | 1) & mask) * inner) & mask
    raise ValueError(f"unknown spray method {method}")


def wam_paths(j, c, sa, sb, lanes, ell, method):
    """Path of lane i of flow f: the count of cumulative profile entries
    <= the spray key of counter (j[f] + i) mod 2**32."""
    ctr = (j.unsqueeze(-1) + torch.arange(lanes, dtype=torch.int64, device=j.device)) & M32
    key = spray_key(ctr, sa.unsqueeze(-1), sb.unsqueeze(-1), ell, method)
    hits = c.to(torch.int64).unsqueeze(-2) <= key.unsqueeze(-1)
    return hits.sum(-1, dtype=torch.int32)


# --------------------------------------------------------------- controller

def cumulative(b):
    return torch.cumsum(b, dim=-1, dtype=torch.int32)


def _f32(v, like):
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _embodiment3(b, r, e):
    """Remove e(i) from the bins with e > 0 and deal the balls evenly over
    the others, the remainder one each round-robin from r."""
    n = b.shape[-1]
    in_kbar = e == 0
    kbar = in_kbar.sum(-1, dtype=torch.int32)
    tot = e.sum(-1, dtype=torch.int32)
    x = torch.div(tot, kbar, rounding_mode="floor")
    y = tot - x * kbar
    b = b - e + torch.where(in_kbar, x.unsqueeze(-1), 0).to(torch.int32)
    walk = (r.unsqueeze(-1) + torch.arange(n, device=b.device)) % n
    on_walk = torch.gather(in_kbar, -1, walk).to(torch.int32)
    rank = torch.cumsum(on_walk, dim=-1, dtype=torch.int32)
    add = ((on_walk == 1) & (rank <= y.unsqueeze(-1))).to(torch.int32)
    b = b.scatter_add(-1, walk, add)
    is_yth = ((rank == y.unsqueeze(-1)) & (on_walk == 1)).to(torch.int32)
    off = torch.argmax(is_yth, dim=-1).to(torch.int32)
    r = torch.where(y > 0, (r + off + 1) % n, r).to(torch.int32)
    return b.to(torch.int32), r


def controller_step(b, r, ewma_w, ecn, loss, rtt, m):
    """The paper's delayed-feedback profile controller, one step: severity
    (ECN + 4 loss + clipped RTT excess), EWMA 0.5, whack-down of degraded
    paths (severity > 0.05, never the least bad) by clip(w)/2 of their
    balls, then a probe that restores a starved healthy path."""
    floor = rtt.min(dim=-1, keepdim=True).values
    excess = torch.where(floor > 0, (rtt - floor) / floor, _f32(0.0, floor))
    w_inst = (ecn + 4.0 * loss) + torch.clamp(excess, 0.0, 4.0) / 4.0
    w = 0.5 * w_inst + (1.0 - 0.5) * ewma_w
    # whack down
    alpha = torch.clamp(w, 0.0, 1.0) * 0.5
    bad = w > _f32(0.05, w)
    bad = bad.scatter(-1, torch.argmin(w, dim=-1, keepdim=True), False)
    e = torch.where(bad, (alpha * b.to(torch.float32)).to(torch.int32), torch.zeros_like(b))
    e = torch.minimum(e, torch.clamp_min(b, 0))
    b_up, r_up = _embodiment3(b, r, e)
    take = (e > 0).any(dim=-1)
    b = torch.where(take.unsqueeze(-1), b_up, b).to(torch.int32)
    r = torch.where(take, r_up, r)
    # restore a starved path
    share = b.to(torch.float32) / _f32(float(m), w)
    starved = (w < _f32(0.01, w)) & (share < _f32(0.02, w))
    target = torch.argmin(torch.where(starved, share, _f32(float("inf"), w)), dim=-1)
    n = b.shape[-1]
    other = torch.arange(n, device=b.device) != target.unsqueeze(-1)
    zero = torch.zeros_like(b)
    give = torch.where(other, (0.125 * b.to(torch.float32)).to(torch.int32), zero)
    donor_b = torch.where(other, b, torch.full_like(b, -1))
    donor = torch.argmax(donor_b, dim=-1, keepdim=True)
    one = zero.scatter(-1, donor, torch.clamp(torch.gather(donor_b, -1, donor), 0, 1))
    give = torch.where((give > 0).any(dim=-1, keepdim=True), give, one)
    restored = (b - give).scatter_add(-1, target.unsqueeze(-1).to(torch.int64),
                                      give.sum(-1, keepdim=True, dtype=torch.int32))
    b = torch.where(starved.any(dim=-1).unsqueeze(-1), restored.to(torch.int32), b)
    return b.to(torch.int32), r, w
