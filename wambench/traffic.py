"""The one traffic generator: a mix file's parameters and a seed in, the
flows' endpoints and the runs' keys out.

A mix (``wambench/traffic/<mix>.json``) names a ``pattern`` and its
parameters; every pattern places ``hosts_per_leaf`` hosts under each leaf
of the configuration's fabric and gives each flow a (source, destination)
pair of hosts on different leaves:

* ``permutation``: every host sends ``fanout`` flows (default 1), the
  i-th to its destination in the i-th of ``fanout`` independent seeded
  random permutations of the hosts, none of which sends a host to its own
  leaf.  So every host also receives ``fanout`` flows: the permutation
  traffic matrix of the fat-tree literature, laid ``fanout`` times over.

Every seed gives the same flow count, message size and rate; only who
talks to whom, and the keys, change.  Seeds are any integers; they are
taken modulo 2**64.
"""
from __future__ import annotations

import numpy as np

# what each stream of random numbers is drawn for, so they never overlap
_PAIRS, _KEYS, _SPRAY, _SAMPLE, _WARM = 1, 2, 3, 4, 5


def _rng(seed: int, *purpose: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 64, *purpose])


def _permutation(rng, leaf_of: np.ndarray) -> np.ndarray:
    """A permutation of the hosts that sends no host to its own leaf:
    a uniform one, then each host still on its own leaf swaps
    destinations with a random host where the swap suits both."""
    N = leaf_of.size
    dst = rng.permutation(N)
    for _ in range(1000):
        bad = np.nonzero(leaf_of[dst] == leaf_of)[0]
        if bad.size == 0:
            return dst
        for h in bad:
            k = int(rng.integers(N))
            if leaf_of[dst[k]] != leaf_of[h] and leaf_of[dst[h]] != leaf_of[k]:
                dst[h], dst[k] = dst[k], dst[h]
    raise RuntimeError("no off-leaf permutation found")


def host_pairs(mix: dict, n_leaves: int, hosts_per_leaf: int, seed: int) -> np.ndarray:
    """The flows' (source host, destination host), int64 [F, 2], sources
    in ascending order."""
    rng = _rng(seed, _PAIRS)
    N = n_leaves * hosts_per_leaf
    if n_leaves < 2:
        raise ValueError("traffic needs two leaves at least")
    src = np.arange(N)
    if mix["pattern"] == "permutation":
        k = int(mix.get("fanout", 1))
        dst = np.stack([_permutation(rng, src // hosts_per_leaf) for _ in range(k)], 1)
        return np.stack([np.repeat(src, k), dst.reshape(-1)], 1)
    raise ValueError(f"unknown traffic pattern {mix['pattern']!r}")


def leaf_pairs(mix: dict, n_leaves: int, hosts_per_leaf: int, seed: int) -> np.ndarray:
    """The flows' (source leaf, destination leaf), int32 [F, 2]: what the
    fabric routes."""
    return (host_pairs(mix, n_leaves, hosts_per_leaf, seed) // hosts_per_leaf).astype(np.int32)


def run_key(seed: int, draw: int):
    """The threefry key (two uint32 words) of run ``draw`` of the seed."""
    k = _rng(seed, _KEYS, draw).integers(0, 2 ** 32, 2)
    return int(k[0]), int(k[1])


def warmup_key(seed: int):
    """The key of the set-up's warm-up run, apart from every draw's."""
    k = _rng(seed, _WARM).integers(0, 2 ** 32, 2)
    return int(k[0]), int(k[1])


def spray_seeds(seed: int):
    """The senders' spray seeds (sa, sb), uint32."""
    k = _rng(seed, _SPRAY).integers(0, 2 ** 32, 2)
    return int(k[0]), int(k[1])


class Sample:
    """The runs whose answers the check compares: ``count`` of a window's
    runs, drawn from the seed uniformly while the window runs (Algorithm
    R), so only ``count`` answers are held however long it runs."""

    def __init__(self, seed: int, count: int):
        self.rng, self.count, self.slots = _rng(seed, _SAMPLE), count, []

    def offer(self, run: int, answer) -> None:
        """Offer run number ``run`` (0, 1, 2, ...) and its answer."""
        if len(self.slots) < self.count:
            self.slots.append((run, answer))
            return
        j = int(self.rng.integers(run + 1))
        if j < self.count:
            self.slots[j] = (run, answer)

    def runs(self) -> list:
        """(run, answer) pairs of the sample, in run order."""
        return sorted(self.slots, key=lambda x: x[0])
