"""The port's exact integer core against `repro.core`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bitrev as jbitrev  # noqa: E402
from repro.core import feedback as jfb  # noqa: E402
from repro.core import profile as jprof  # noqa: E402
from repro.core import spray as jspray  # noqa: E402
from repro.core import updates as jupd  # noqa: E402
from repro.core.deviation import interval_deviation, spray_keys_np  # noqa: E402
from repro_torch.core import bitrev, feedback, profile, spray, updates  # noqa: E402

SEEDS = list(range(8))


def t64(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("ell", [1, 8, 10, 16, 31, 32])
def test_theta_matches(ell):
    js = np.random.default_rng(ell).integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(np.asarray(jbitrev.theta(js, ell)).astype(np.int64),
                          bitrev.theta(t64(js), ell).numpy())


@pytest.mark.parametrize("method", list(spray.SprayMethod))
@pytest.mark.parametrize("ell", [4, 8, 10, 16])
def test_spray_key_every_counter(method, ell):
    rng = np.random.default_rng(ell * 10 + int(method))
    m = 1 << ell
    js = np.concatenate([np.arange(2 * m if ell <= 10 else 4096),
                         rng.integers(0, 2**32, 512)]).astype(np.uint32)
    for sa, sb in ((0, 1), (int(rng.integers(0, m)), int(rng.integers(0, m // 2)) * 2 + 1)):
        want = np.asarray(jspray.spray_key(js, np.uint32(sa), np.uint32(sb), ell, int(method)))
        got = spray.spray_key(t64(js), torch.tensor(sa), torch.tensor(sb), ell, int(method))
        assert np.array_equal(want.astype(np.int64), got.numpy())


@pytest.mark.parametrize("n", [4, 8, 16])
def test_profile_and_select_path(n):
    rng = np.random.default_rng(n)
    for ell in (8, 10):
        frac = rng.random(n) + 0.01
        jp = jprof.quantize_profile(frac, ell)
        tp = profile.quantize_profile(frac, ell)
        assert np.array_equal(np.asarray(jp.b), tp.b.numpy())
        assert np.array_equal(np.asarray(jp.c), tp.c.numpy())
        assert np.array_equal(np.asarray(jprof.uniform_profile(n, ell).b),
                              profile.uniform_profile(n, ell).b.numpy())
        keys = rng.integers(0, 1 << ell, 1000)
        want = np.asarray(jspray.select_path(jp.c, keys))
        assert np.array_equal(want, spray.select_path(tp.c, t64(keys)).numpy())


def test_combined_counterexample_pinned():
    """COMBINED keys over [127, 256) at sa=124, sb=245, ell=8 reproduce the
    reference exactly, including its deviation of 21.03 balls (above the
    2*ell the reference's docstring claims; the bound is not asserted)."""
    ell, sa, sb, lo, hi = 8, 124, 245, 127, 256
    m = 1 << ell
    js = torch.arange(2 * m) % m
    keys = spray.spray_key(js, torch.tensor(sa), torch.tensor(sb), ell,
                           spray.SprayMethod.COMBINED).numpy()
    assert np.array_equal(keys, spray_keys_np(ell, 3, sa, sb, 0, 2 * m))
    h = ((keys >= lo) & (keys < hi)).astype(np.int64)
    prefix = np.concatenate([[0], np.cumsum(h)])
    lens = np.arange(1, m + 1)
    win = prefix[np.arange(m)[:, None] + lens[None, :]] - prefix[np.arange(m)[:, None]]
    scaled = m * win - (hi - lo) * lens[None, :]
    dev = (np.maximum(scaled.max(1), 0) - np.minimum(scaled.min(1), 0)).max()
    assert dev == 5383  # 21.027 balls
    assert dev / m == interval_deviation(ell, 3, sa, sb, lo, hi)


def _rand_b_e(rng, n, ell, degraded):
    b = np.bincount(rng.integers(0, n, 1 << ell), minlength=n).astype(np.int32)
    e = np.where(degraded, (rng.random(n) * 0.5 * b).astype(np.int32), 0).astype(np.int32)
    return b, e


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [4, 8, 16])
def test_updates_embodiments_3_and_4(seed, n):
    rng = np.random.default_rng(seed * 31 + n)
    degraded = rng.random(n) < 0.4
    degraded[rng.integers(0, n)] = False
    degraded[rng.integers(0, n)] = True
    b, e = _rand_b_e(rng, n, 10, degraded)
    r = int(rng.integers(0, n))
    for jf, tf in ((jupd.update_embodiment3, updates.update_embodiment3),
                   (jupd.update_embodiment4, updates.update_embodiment4)):
        jb, jr = jf(jnp.asarray(b), jnp.int32(r), jnp.asarray(e))
        tb, tr = tf(torch.as_tensor(b)[None], torch.tensor([r], dtype=torch.int32),
                    torch.as_tensor(e)[None])
        assert np.array_equal(np.asarray(jb), tb[0].numpy())
        assert int(jr) == int(tr[0])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [4, 8, 16])
def test_controller_step_batched(seed, n):
    """A batch of flows through several controller steps equals each flow
    stepped alone by the reference (whack_down and restore_path included)."""
    rng = np.random.default_rng(1000 + seed * 7 + n)
    F, ell = 4, 10
    b0 = np.stack([np.bincount(rng.integers(0, n, 1 << ell), minlength=n) for _ in range(F)])
    tstate = feedback.make_controller(profile.make_profile(torch.as_tensor(b0), ell))
    jstates = [jfb.make_controller(jprof.make_profile(b0[f], ell)) for f in range(F)]
    jstep = jax.jit(jfb.controller_step)
    for _ in range(6):
        ecn = (rng.random((F, n)) * (rng.random((F, n)) < 0.3)).astype(np.float32)
        loss = (rng.random((F, n)) * 0.2 * (rng.random((F, n)) < 0.2)).astype(np.float32)
        rtt = (4 + rng.random((F, n)) * 6).astype(np.float32)
        tstate, tw = feedback.controller_step(tstate, feedback.PathStats(
            torch.as_tensor(ecn), torch.as_tensor(loss), torch.as_tensor(rtt)))
        for f in range(F):
            jstates[f], jw = jstep(jstates[f], jfb.PathStats(
                jnp.asarray(ecn[f]), jnp.asarray(loss[f]), jnp.asarray(rtt[f])))
            assert np.array_equal(np.asarray(jw), tw[f].numpy())
            assert np.array_equal(np.asarray(jstates[f].profile.b), tstate.profile.b[f].numpy())
            assert np.array_equal(np.asarray(jstates[f].profile.c), tstate.profile.c[f].numpy())
            assert int(jstates[f].r) == int(tstate.r[f])


def test_restore_path_small_m_fallback():
    b = np.array([1, 1, 1, 0, 1, 1, 1, 10], dtype=np.int32)
    jst = jax.jit(jfb.restore_path)(jfb.make_controller(jprof.make_profile(b, 4)), 3)
    tst = feedback.restore_path(
        feedback.make_controller(profile.make_profile(torch.as_tensor(b)[None], 4)),
        torch.tensor([3]))
    assert np.array_equal(np.asarray(jst.profile.b), tst.profile.b[0].numpy())
