"""A 3-tier multi-pod fat-tree (Al-Fares et al., SIGCOMM 2008), built plainly.

Pods of ``leaves_per_pod`` leaves and ``spines_per_pod`` spines; spine s of
every pod reaches the ``cores_per_spine`` cores of core plane s.  A flow
between pods has one 4-hop path per (spine s, core j), numbered s * C + j:
leaf -> spine s -> core (s, j) -> spine s of the other pod -> leaf.  A flow
inside a pod turns at spine s, and its two middle hops ride a virtual
bypass link of unbounded capacity (the last link id).

Link ids: leaf->spine [0, P Lp S), spine->core (next P S C), core->spine
(next P S C, core-major then pod), spine->leaf (next P S Lp), the bypass.
"""
from __future__ import annotations

import numpy as np

BYPASS_CAPACITY = 1e9


def leaves(sizes: dict) -> int:
    return sizes["n_pods"] * sizes["leaves_per_pod"]


def build(sizes: dict, links: dict, pairs: np.ndarray) -> dict:
    P, Lp = sizes["n_pods"], sizes["leaves_per_pod"]
    S, C = sizes["spines_per_pod"], sizes["cores_per_spine"]
    up = float(links["uplink_capacity"])
    down = float(links.get("downlink_capacity", up))
    core = float(links.get("core_capacity", up))
    F = pairs.shape[0]
    sp, sl = pairs[:, 0] // Lp, pairs[:, 0] % Lp
    dp, dl = pairs[:, 1] // Lp, pairs[:, 1] % Lp
    q = np.arange(S * C)
    s, j = (q // C)[None, :], (q % C)[None, :]
    inter = (sp != dp)[:, None]
    n_ls, n_sc = P * Lp * S, P * S * C
    bypass = 2 * n_ls + 2 * n_sc
    hop0 = (sp[:, None] * Lp + sl[:, None]) * S + s
    hop1 = np.where(inter, n_ls + (sp[:, None] * S + s) * C + j, bypass)
    hop2 = np.where(inter, n_ls + n_sc + (s * C + j) * P + dp[:, None], bypass)
    hop3 = n_ls + 2 * n_sc + (dp[:, None] * S + s) * Lp + dl[:, None]
    route = np.stack([hop0, hop1, hop2, hop3]).astype(np.int64)
    L = bypass + 1
    cap = np.concatenate([np.full(n_ls, up), np.full(2 * n_sc, core), np.full(n_ls, down),
                          [BYPASS_CAPACITY]]).astype(np.float32)
    qlim = np.full(L, links["queue_limit"], np.float32)
    ecn = np.full(L, links["ecn_threshold"], np.float32)
    qlim[-1] = ecn[-1] = BYPASS_CAPACITY
    deg = np.full(L, links["degrade_p"], np.float32)
    deg[-1] = 0.0
    lat = np.where(inter, links["latency_ticks"], links["intra_latency_ticks"])
    return dict(route=route, capacity=cap, queue_limit=qlim, ecn_threshold=ecn,
                latency=np.broadcast_to(lat, (F, S * C)).astype(np.int32),
                degrade_p=deg, recover_p=np.full(L, links["recover_p"], np.float32),
                degrade_factor=np.full(L, links["degrade_factor"], np.float32),
                fb_delay=int(links["fb_delay"]), ring_len=int(links["ring_len"]))
