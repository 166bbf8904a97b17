"""The reference's two float primitives against exact arithmetic: `fma32`
rounds a * b + c once, as rationals would, and `ring_deposit` adds each
path's value into its slot in path order."""
from fractions import Fraction

import numpy as np
import pytest
import torch

from wambench.reference import sim


def _round_f32(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    best = min(abs(Fraction(float(c)) - x) for c in cands)
    near = [c for c in cands if abs(Fraction(float(c)) - x) == best]
    return near[0] if len(near) == 1 else next(c for c in near if c.view(np.int32) % 2 == 0)


def _exact_fma(a, b, c) -> np.ndarray:
    return np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)


def test_fma32_rounds_once():
    rng = np.random.default_rng(3)
    n = 4000
    a = (rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8, n)).astype(np.float32)
    b = (rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8, n)).astype(np.float32)
    c = (rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8, n)).astype(np.float32)
    c[::3] = -(a[::3].astype(np.float64) * b[::3]).astype(np.float32)  # near cancellation
    # a float64 sum that lands on a float32 midpoint: rounding twice goes
    # to the even neighbour, 1 + 2**-22; once, to 1 + 2**-23
    edge = (np.float32(1 + 2 ** -20), np.float32(2 ** -24 * (1 - 2 ** -20)),
            np.float32(1 + 2 ** -23))
    a, b, c = (np.concatenate([v, [e, -e]]).astype(np.float32)
               for v, e in zip((a, b, c), (edge[0], edge[1], edge[2])))
    b[-1] = -b[-1]  # -a * b - c, the mirror case
    got = sim.fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = _exact_fma(a, b, c)
    assert want[-2] == np.float32(1 + 2 ** -23) and want[-1] == -want[-2]
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("zeros", [False, True])
def test_ring_deposit_adds_in_path_order(zeros):
    rng = np.random.default_rng(4)
    F, R, n = 6, 5, 9
    ring = rng.standard_normal((F, R)).astype(np.float32) * 1e4
    slot = rng.integers(0, R, (F, n))
    slot[0] = 2  # every path of flow 0 in one slot
    vals = (rng.standard_normal((F, n)) * 10.0 ** rng.integers(-3, 4, (F, n))).astype(np.float32)
    if zeros:  # adding 0 leaves a slot's bits
        vals[:, ::2] = 0.0
    want = ring.copy()
    for f in range(F):
        for p in range(n):
            want[f, slot[f, p]] = np.float32(want[f, slot[f, p]] + vals[f, p])
    got = sim.ring_deposit(torch.from_numpy(ring), torch.from_numpy(slot).to(torch.int32),
                           torch.from_numpy(vals)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
