"""Profile updates, embodiments 1-4 (paper §7): the port's vectorised
updates and its pseudocode oracles against `repro.core.updates`, over the
hypothesis strategies of `tests/test_updates.py` (skips without
hypothesis, as that file does)."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, strategies as st  # noqa: E402

from repro.core import updates as jupd  # noqa: E402
from repro_torch.core import updates  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "reference_update_strategies", pathlib.Path(__file__).with_name("test_updates.py"))
strategies = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(strategies)

_j1 = jax.jit(jupd.update_embodiment1)
_j2 = jax.jit(jupd.update_embodiment2)
_j3 = jax.jit(jupd.update_embodiment3)
_j4 = jax.jit(jupd.update_embodiment4)


def _t(x):
    return torch.as_tensor(np.array(x, np.int32))


def _check(want, oracle, got_batched, got_flat, ref_oracle):
    (jb, jr), (ob, orr), (tb, tr), (fb, fr), (rb, rr) = (
        want, oracle, got_batched, got_flat, ref_oracle)
    assert np.array_equal(np.asarray(jb), tb[0].numpy()) and int(jr) == int(tr[0])
    assert np.array_equal(fb.numpy(), tb[0].numpy()) and int(fr) == int(tr[0])
    assert np.array_equal(ob, rb) and orr == rr  # the two oracles agree
    assert np.array_equal(ob, tb[0].numpy()) and orr == int(tr[0])


@given(strategies._profile_strategy(), st.data())
def test_embodiment1_matches(b, data):
    n = len(b)
    r = data.draw(st.integers(0, n - 1))
    j = data.draw(st.integers(0, n - 1))
    e_j = data.draw(st.integers(0, int(b[j])))
    _check(_j1(jnp.asarray(b), jnp.int32(r), jnp.int32(j), jnp.int32(e_j)),
           updates.ref_embodiment1(b, r, j, e_j),
           updates.update_embodiment1(_t(b)[None], _t([r]), _t([j]), _t([e_j])),
           updates.update_embodiment1(_t(b), _t(r), _t(j), _t(e_j)),
           jupd.ref_embodiment1(b, r, j, e_j))


@given(strategies._profile_strategy(), st.data())
def test_embodiment2_matches(b, data):
    n = len(b)
    r = data.draw(st.integers(0, n - 1))
    e = np.asarray([data.draw(st.integers(0, int(b[i]))) for i in range(n)], np.int32)
    _check(_j2(jnp.asarray(b), jnp.int32(r), jnp.asarray(e)),
           updates.ref_embodiment2(b, r, e),
           updates.update_embodiment2(_t(b)[None], _t([r]), _t(e)[None]),
           updates.update_embodiment2(_t(b), _t(r), _t(e)),
           jupd.ref_embodiment2(b, r, e))


@given(strategies._profile_strategy(max_n=10), st.data())
def test_embodiments_3_and_4_match(b, data):
    n = len(b)
    r = data.draw(st.integers(0, n - 1))
    e = strategies._removal_with_kbar(data, b)
    if e is None:
        return
    _check(_j3(jnp.asarray(b), jnp.int32(r), jnp.asarray(e)),
           updates.ref_embodiment3(b, r, e),
           updates.update_embodiment3(_t(b)[None], _t([r]), _t(e)[None]),
           updates.update_embodiment3(_t(b), _t(r), _t(e)),
           jupd.ref_embodiment3(b, r, e))
    if int(e.sum()) < int(b.sum()):
        _check(_j4(jnp.asarray(b), jnp.int32(r), jnp.asarray(e)),
               updates.ref_embodiment4(b, r, e),
               updates.update_embodiment4(_t(b)[None], _t([r]), _t(e)[None]),
               updates.update_embodiment4(_t(b), _t(r), _t(e)),
               jupd.ref_embodiment4(b, r, e))


def test_residual_fairness_across_updates():
    """The persistent residual index r spreads residual balls evenly: the
    port's embodiment 1, applied 25 times, against its own oracle."""
    from repro_torch.core.profile import quantize_counts

    tb, tr = _t(quantize_counts([1, 1, 1, 1, 1], 10)), _t(0)
    received = np.zeros(5, np.int64)
    for _ in range(25):
        before = tb.numpy().astype(np.int64)
        tb, tr = updates.update_embodiment1(tb, tr, _t(0), _t(7))
        expected = before + 7 // 5
        expected[0] -= 7
        received += tb.numpy() - expected
    assert received.sum() == 50 and received.max() - received.min() <= 2
