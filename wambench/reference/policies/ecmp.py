"""ECMP: every packet of a flow takes the flow's one hashed path, and no
controller runs, so the profile stays the even one it starts from."""
from __future__ import annotations

CONTROLLER = False


def start(ctx) -> dict:
    return dict(b=ctx.b0)


def paths(ctx, st: dict, j):
    return ctx.ecmp.unsqueeze(-1).expand(-1, ctx.lanes)


def feedback(ctx, st: dict, t: int, ecn, loss, rtt) -> dict:
    return st


def profile(st: dict):
    return st["b"]
