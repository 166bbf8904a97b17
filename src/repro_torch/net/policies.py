"""Path-selection policies: the paper's baselines and the literature's
adaptive sprayers, one branch each.

The JAX engine picks a branch with a traced `lax.switch`; here the policy
is a concrete id and `assign_lanes` dispatches in Python.  Each branch maps
a tick's ``rate_cap`` emission lanes of every flow to path ids
``int32[F, rate_cap]``.  The WAM branch is one launch of the `spray_select`
kernel's row-base form, on the flows' own int64 counters and seeds.  A
state-bearing policy whose block is disabled falls back to RAND_STATIC, as
in the reference.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence, Tuple

import torch

from repro_torch.core.profile import PathProfile
from repro_torch.core.spray import SprayState, select_path, spray_key
from repro_torch.kernels.spray_select import spray_select_rows, spray_select_rows_plain
from repro_torch.net.policy_state import PolicyState, canon_blocks
from repro_torch.numerics import fold_cumsum
from repro_torch.random import M32

__all__ = ["Policy", "BASELINE_POLICIES", "ALL_POLICIES", "PolicyDef",
           "POLICY_DEFS", "blocks_for", "profile_adaptive", "uses_rng",
           "STRACK_SLACK", "strack_scores", "assign_lanes"]


class Policy(enum.IntEnum):
    ECMP = 0
    RR = 1
    RAND_STATIC = 2
    RAND_ADAPTIVE = 3
    WAM = 4
    PRIME = 5
    STRACK = 6
    CC_COUPLED = 7


BASELINE_POLICIES: Tuple[Policy, ...] = tuple(Policy)[:5]
ALL_POLICIES: Tuple[Policy, ...] = tuple(Policy)


@dataclasses.dataclass(frozen=True)
class PolicyDef:
    policy: Policy
    blocks: Tuple[str, ...] = ()
    profile_adaptive: bool = False


POLICY_DEFS: Tuple[PolicyDef, ...] = (
    PolicyDef(Policy.ECMP),
    PolicyDef(Policy.RR),
    PolicyDef(Policy.RAND_STATIC),
    PolicyDef(Policy.RAND_ADAPTIVE, profile_adaptive=True),
    PolicyDef(Policy.WAM, profile_adaptive=True),
    PolicyDef(Policy.PRIME, blocks=("entropy",)),
    PolicyDef(Policy.STRACK, blocks=("rtt", "penalty")),
    PolicyDef(Policy.CC_COUPLED, blocks=("ccw",)),
)
_DEF_BY_POLICY = {d.policy: d for d in POLICY_DEFS}

STRACK_SLACK = 0.5


def blocks_for(policies: Sequence[Policy | int]) -> Tuple[str, ...]:
    want = set()
    for p in policies:
        want.update(_DEF_BY_POLICY[Policy(int(p))].blocks)
    return canon_blocks(want)


def profile_adaptive(policy: Policy | int) -> bool:
    """Does the policy drive the WaM profile controller?"""
    return _DEF_BY_POLICY[Policy(int(policy))].profile_adaptive


def _branch(policy: Policy | int, pstate: PolicyState) -> Policy:
    """The branch that runs: a state-bearing policy without its block
    degrades to RAND_STATIC."""
    policy = Policy(int(policy))
    width = {
        Policy.PRIME: pstate.entropy.shape[-1],
        Policy.STRACK: pstate.rtt.shape[-1] and pstate.penalty.shape[-1],
        Policy.CC_COUPLED: pstate.ccw.shape[-1],
    }.get(policy, 1)
    return policy if width else Policy.RAND_STATIC


def uses_rng(policy: Policy | int, pstate: PolicyState) -> bool:
    """Does the branch that runs draw per-lane random integers?"""
    return _branch(policy, pstate) in (Policy.RAND_STATIC, Policy.RAND_ADAPTIVE)


def strack_scores(state: PolicyState):
    """STrack per-path (score, eligible): penalty plus normalised RTT excess;
    eligible within STRACK_SLACK of the best score."""
    rtt, pen = state.rtt, state.penalty
    base = rtt.min(dim=-1, keepdim=True).values
    score = pen + (rtt - base) / torch.clamp_min(base, 1.0)
    good = score <= score.min(dim=-1, keepdim=True).values + STRACK_SLACK
    return score, good


def assign_lanes(policy: Policy | int, rate_cap: int, n: int, spray: SprayState,
                 profile: PathProfile, ecmp_path: torch.Tensor,
                 pstate: PolicyState, rand_lanes: torch.Tensor | None, *,
                 plain_spray: bool = False) -> torch.Tensor:
    """Path ids int32[F, rate_cap] for lane l of flow f (counter j[f] + l).

    ``rand_lanes`` holds this tick's per-flow random integers in [0, n) for
    RAND_STATIC or [0, m) for RAND_ADAPTIVE (None for the other branches).
    ``plain_spray`` runs the WAM branch through the kernel's plain version."""
    branch = _branch(policy, pstate)
    if branch == Policy.ECMP:
        return ecmp_path.unsqueeze(-1).expand(-1, rate_cap).to(torch.int32)
    if branch == Policy.RAND_STATIC:
        return rand_lanes
    if branch == Policy.RAND_ADAPTIVE:
        return select_path(profile.c, rand_lanes)
    if branch == Policy.WAM:  # one kernel launch: the lanes' counters are formed in it
        select = spray_select_rows_plain if plain_spray else spray_select_rows
        return select(spray.j, profile.c, spray.sa, spray.sb, rate_cap, ell=spray.ell,
                      method=spray.method)
    lanes = torch.arange(rate_cap, dtype=torch.int64, device=spray.j.device)
    counters = (spray.j.unsqueeze(-1) + lanes) & M32  # [F, rate_cap]
    if branch == Policy.RR:
        return (counters % n).to(torch.int32)
    if branch == Policy.PRIME:
        ent = torch.gather(pstate.entropy, -1, counters % n)
        return (ent % n).to(torch.int32)
    if branch == Policy.STRACK:
        _, good = strack_scores(pstate)
        k = torch.cumsum(good.to(torch.int32), dim=-1)
        slot = counters % k[..., -1:].to(torch.int64)
        return (k.unsqueeze(-2) < (slot + 1).unsqueeze(-1)).sum(-1, dtype=torch.int32)
    # CC_COUPLED: WaM's key sequence mapped through the windows' CDF
    keys = spray_key(counters, spray.sa.unsqueeze(-1), spray.sb.unsqueeze(-1),
                     spray.ell, spray.method)
    cum = fold_cumsum(pstate.ccw)
    unit = (keys.to(torch.float32) + 0.5) / float(profile.m)
    v = unit * cum[..., -1:]
    path = (cum.unsqueeze(-2) < v.unsqueeze(-1)).sum(-1, dtype=torch.int32)
    return torch.clamp(path, 0, n - 1)
