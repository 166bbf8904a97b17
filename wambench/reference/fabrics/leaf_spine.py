"""A 2-tier leaf-spine, built plainly.

A flow from leaf a to leaf b has one path per spine p: uplink (a, p), then
downlink (p, b).  Link ids: the uplinks leaf-major, then the downlinks
spine-major.
"""
from __future__ import annotations

import numpy as np


def leaves(sizes: dict) -> int:
    return sizes["n_leaves"]


def build(sizes: dict, links: dict, pairs: np.ndarray) -> dict:
    NL, NS = sizes["n_leaves"], sizes["n_spines"]
    up = float(links["uplink_capacity"])
    down = float(links.get("downlink_capacity", up))
    F = pairs.shape[0]
    p = np.arange(NS)[None, :]
    route = np.stack([pairs[:, :1] * NS + p, NL * NS + p * NL + pairs[:, 1:]]).astype(np.int64)
    L = 2 * NL * NS
    full = lambda v: np.full(L, v, np.float32)  # noqa: E731
    return dict(route=route,
                capacity=np.concatenate([np.full(NL * NS, up), np.full(NL * NS, down)])
                .astype(np.float32),
                queue_limit=full(links["queue_limit"]),
                ecn_threshold=full(links["ecn_threshold"]),
                latency=np.full((F, NS), links["latency_ticks"], np.int32),
                degrade_p=full(links["degrade_p"]), recover_p=full(links["recover_p"]),
                degrade_factor=full(links["degrade_factor"]),
                fb_delay=int(links["fb_delay"]), ring_len=int(links["ring_len"]))
