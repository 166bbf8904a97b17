"""Plain sender policies, one module a policy, named as a mix names it in
lower case (``WAM`` is ``wam.py``).  Each module has

* ``CONTROLLER``: whether the policy drives a profile controller, whose
  last profile the check then compares;
* ``start(ctx)``: the policy's state before the first tick;
* ``paths(ctx, state, j)``: the path of each lane of each flow this tick,
  ``[F, lanes]``, from the flows' packet counters ``j``;
* ``feedback(ctx, state, t, ecn, loss, rtt)``: the state after tick ``t``'s
  delayed feedback, per flow and path;
* ``profile(state)``: the flows' profile, int32 ``[F, n]``.

``ctx`` holds the run's constants: ``F``, ``n``, ``m``, ``lanes``, ``ell``,
``method``, ``ctrl_interval``, the per-flow spray seeds ``sa_f`` and
``sb_f``, the hashed path ``ecmp`` and the even profile ``b0``.
"""
from __future__ import annotations

import importlib


def find(name: str):
    """The module of policy ``name``."""
    return importlib.import_module(f"{__name__}.{name.lower()}")
