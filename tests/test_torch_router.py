"""The port's request router against `repro.serve_router`, on the CPU.

A scripted run of `assign`, `report` and `simulate_window` must give the
reference's replica ids, sequence numbers, float32 severity weights and
shares exactly; the port also passes every assertion of
`tests/test_serve_router.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import spray as jspray  # noqa: E402
from repro.serve_router import Router as JRouter  # noqa: E402
from repro.serve_router import RouterReport as JReport  # noqa: E402
from repro_torch.serve_router import Router, RouterReport  # noqa: E402


def _router(weights, **kw):
    return Router(weights, device="cpu", **kw)


@pytest.mark.parametrize("weights,ell,method", [
    ([1, 2, 1], 10, 1),
    ([1, 1, 1, 1, 1], 8, 2),
    ([0.5, 3.0, 1.0, 1.0, 2.0, 0.1, 1.0, 4.0], 10, 3),
])
def test_scripted_run_matches_reference(weights, ell, method):
    n = len(weights)
    ref = JRouter(weights, ell=ell, method=method, seed=(17, 40))
    port = _router(weights, ell=ell, method=method, seed=(17, 40))
    rng = np.random.default_rng(n)
    service = np.full(n, 5.0)
    for window in range(8):
        service[n - 1] = 40.0 if 2 <= window < 6 else 5.0
        if window % 3 == 2:  # a bare assign, sequence numbers included
            want_paths, want_seqs, ref._spray = jspray.spray_batch(
                ref._spray, ref._ctrl.profile, 37)
            got = port.assign(37)
            assert got.dtype == np.asarray(want_paths).dtype
            assert np.array_equal(got, np.asarray(want_paths))
            assert np.array_equal(port.last_seqs, np.asarray(want_seqs))
            assert port.last_ids is got
            continue
        want_rep = ref.simulate_window(64, service)
        got_rep = port.simulate_window(64, service)
        for field in ("latency_ms", "error_rate", "queue_depth"):
            assert np.array_equal(getattr(got_rep, field), getattr(want_rep, field))
        errors = np.where(rng.random(n) < 0.2, 0.3, 0.0)
        depth = want_rep.queue_depth * (1 + window % 2) * 1.5
        want_w = ref.report(JReport(want_rep.latency_ms, errors, depth))
        got_w = port.report(RouterReport(got_rep.latency_ms, errors, depth))
        assert got_w.dtype == np.float32 and np.array_equal(got_w, want_w)
        got_s, want_s = port.shares, ref.shares
        assert got_s.dtype == want_s.dtype and np.array_equal(got_s, want_s)
    assert np.array_equal(port._spray.path_seq.numpy(), np.asarray(ref._spray.path_seq))


def test_router_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Router([1, 1])


# --- the assertions of tests/test_serve_router.py, on the port -----------


def test_assignments_track_shares_exactly_over_period():
    ids = _router([1, 2, 1]).assign(1024)
    assert np.bincount(ids, minlength=3).tolist() == [256, 512, 256]


def test_every_window_within_bound():
    ids = _router([1, 1, 1, 1], ell=8).assign(2048)
    pref = np.cumsum(np.eye(4, dtype=np.int64)[ids], axis=0)
    lens = np.arange(1, 2049)[:, None]
    assert np.abs(pref - lens * 0.25).max() <= 8


def test_slow_replica_gets_whacked_and_recovers():
    r = _router([1, 1, 1, 1])
    healthy = np.full(4, 10.0)
    slow = healthy.copy()
    slow[2] = 80.0
    for _ in range(6):
        r.report(RouterReport(latency_ms=slow, error_rate=np.zeros(4), queue_depth=np.zeros(4)))
    during = r.shares
    assert during[2] < 0.10
    assert abs(during.sum() - 1.0) < 1e-9
    for _ in range(40):
        r.report(RouterReport(latency_ms=healthy, error_rate=np.zeros(4),
                              queue_depth=np.zeros(4)))
    assert r.shares[2] > during[2]


def test_errors_trigger_whack():
    r = _router([1, 1])
    for _ in range(4):
        r.report(RouterReport(latency_ms=np.full(2, 10.0), error_rate=np.array([0.0, 0.4]),
                              queue_depth=np.zeros(2)))
    assert r.shares[1] < 0.2


def test_closed_loop_simulation():
    rng = np.random.default_rng(0)
    r = _router([1, 1, 1, 1])
    service = np.array([5.0, 5.0, 40.0, 5.0])
    for _ in range(10):
        r.report(r.simulate_window(64, service, rng))
    counts = np.bincount(r.assign(1024), minlength=4)
    assert counts[2] < counts.min(initial=1025, where=np.arange(4) != 2)
