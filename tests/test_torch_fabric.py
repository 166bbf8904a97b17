"""One and several ticks of the port's fabrics against the jitted reference,
and the float association of the ring deposits."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.net import fabric as jfab  # noqa: E402
from repro.net import topology as jtop  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.net import fabric as tfab  # noqa: E402
from repro_torch.net import topology as ttop  # noqa: E402

FAB_FIELDS = ("capacity", "latency", "queue_limit", "ecn_threshold", "degrade_p",
              "recover_p", "degrade_factor")
TOPO_FIELDS = ("route",) + FAB_FIELDS


def port_fabric(p):
    return convert.fabric_params({k: np.asarray(getattr(p, k)) for k in FAB_FIELDS},
                                 fb_delay=p.fb_delay, ring_len=p.ring_len)


def port_topo(t):
    return convert.topology_params({k: np.asarray(getattr(t, k)) for k in TOPO_FIELDS},
                                   fb_delay=t.fb_delay, ring_len=t.ring_len)


def port_state(cls, jstate, t):
    """A port state holding the reference state's values."""
    vals = {f.name: torch.as_tensor(np.array(getattr(jstate, f.name)))
            for f in dataclasses.fields(cls) if f.name != "t"}
    return cls(**vals, t=t)


def assert_state_equal(jstate, tstate):
    for f in dataclasses.fields(tstate):
        want = np.asarray(getattr(jstate, f.name))
        got = getattr(tstate, f.name)
        got = np.asarray(got) if f.name == "t" else got.numpy()
        assert np.array_equal(want, got), f.name


def assert_fb_equal(jfb, tfb):
    for k in ("sent", "marked", "dropped", "qdelay", "landed"):
        assert np.array_equal(np.asarray(jfb[k]), tfb[k].numpy()), k


def bundle_params(n, degrade_p=0.05):
    return jfab.FabricParams(
        capacity=jnp.full((n,), 3.5), latency=jnp.full((n,), 3, jnp.int32),
        queue_limit=jnp.full((n,), 10.0), ecn_threshold=jnp.full((n,), 4.0),
        degrade_p=jnp.full((n,), degrade_p), recover_p=jnp.full((n,), 0.2),
        degrade_factor=jnp.full((n,), 0.3), fb_delay=4, ring_len=32)


@pytest.mark.parametrize("n", [4, 8, 16])
def test_fabric_tick_matches_jitted(n):
    jp = bundle_params(n)
    tp = port_fabric(jp)
    tick = jax.jit(jfab.fabric_tick)
    rng = np.random.default_rng(n)
    js, ts = jfab.init_fabric(jp), tfab.init_fabric(tp, (1,))
    with jax.threefry_partitionable(False):
        for t in range(24):
            arr = (rng.integers(0, 4, n) * (rng.random(n) < 0.8)).astype(np.float32)
            key = jax.random.fold_in(jax.random.PRNGKey(n), t)
            js, jfb = tick(jp, js, jnp.asarray(arr), key)
            u = prng.uniform(torch.as_tensor(np.asarray(key).astype(np.int64)), (n,))
            ts, tfb = tfab.fabric_tick(tp, ts, torch.as_tensor(arr)[None], u[None])
            squeezed = dataclasses.replace(
                ts, **{f.name: getattr(ts, f.name)[0] for f in dataclasses.fields(ts)
                       if f.name != "t"})
            assert_state_equal(js, squeezed)
            assert_fb_equal(jfb, {k: v[0] for k, v in tfb.items()})


def test_fabric_deposit_folds_onto_ring():
    """Two paths landing in one slot: the jitted seed fabric folds them onto
    the ring, (ring + a) + b, which differs from ring + (a + b) here (XLA
    fuses the ring's add into the one-hot contraction)."""
    jp = bundle_params(2, degrade_p=0.0)
    a = 2.0 ** -24
    js = dataclasses.replace(jfab.init_fabric(jp),
                             arrive_ring=jnp.zeros(32).at[4].set(1.0))
    with jax.threefry_partitionable(False):
        js2, _ = jax.jit(jfab.fabric_tick)(jp, js, jnp.asarray([a, a], jnp.float32),
                                           jax.random.PRNGKey(0))
    ts = port_state(tfab.FabricState, js, 0)
    ts2, _ = tfab.fabric_tick(port_fabric(jp), ts, torch.tensor([a, a]), torch.ones(2))
    ring = np.asarray(js2.arrive_ring)
    assert ring[4] == np.float32(1.0) != np.float32(1.0) + np.float32(2 * a)
    assert np.array_equal(ring, ts2.arrive_ring.numpy())


def shared_case(n_spines, seed):
    pairs = [(0, 1), (0, 2), (3, 1), (2, 3), (1, 0), (0, 3)]
    topo = jtop.leaf_spine(4, n_spines, pairs, uplink_capacity=2.5, queue_limit=9.0,
                           ecn_threshold=3.0, degrade_p=0.05, recover_p=0.2,
                           degrade_factor=0.2, fb_delay=4, ring_len=32)
    rng = np.random.default_rng(seed)
    T = 6
    sched = jtop.EventSchedule(
        cap_scale=jnp.asarray((0.5 + rng.random((T, topo.links))).astype(np.float32)),
        bg_arrivals=jnp.asarray((rng.random((T, topo.links)) * 3
                                 * (rng.random((T, topo.links)) < 0.3)).astype(np.float32)))
    return topo, sched


@pytest.mark.parametrize("n_spines", [4, 8, 16])
def test_shared_fabric_tick_matches_jitted(n_spines):
    topo, sched = shared_case(n_spines, n_spines)
    ttopo = port_topo(topo)
    tsched = convert.event_schedule({"cap_scale": np.asarray(sched.cap_scale),
                                     "bg_arrivals": np.asarray(sched.bg_arrivals)})
    tick = jax.jit(lambda s, a, k: jtop.shared_fabric_tick(topo, sched, s, a, k))
    rng = np.random.default_rng(100 + n_spines)
    js, ts = jtop.init_shared_fabric(topo), ttop.init_shared_fabric(ttopo)
    with jax.threefry_partitionable(False):
        for t in range(20):
            arr = (rng.integers(0, 5, (topo.flows, topo.n))
                   * (rng.random((topo.flows, topo.n)) < 0.7)).astype(np.float32)
            key = jax.random.fold_in(jax.random.PRNGKey(7), t)
            js, jfb = tick(js, jnp.asarray(arr), key)
            u = prng.uniform(torch.as_tensor(np.asarray(key).astype(np.int64)), (topo.links,))
            ts, tfb = ttop.shared_fabric_tick(ttopo, tsched, ts, torch.as_tensor(arr), u)
            assert_state_equal(js, ts)
            assert_fb_equal(jfb, tfb)
    for want, got in zip(jax.jit(lambda s: jtop.link_telemetry(topo, s))(js),
                         ttop.link_telemetry(ttopo, ts)):
        assert np.array_equal(np.asarray(want), got.numpy())


def test_shared_delivery_folds_onto_ring():
    """Two paths of one flow landing in one slot: the jitted shared fabric
    folds them onto the ring, (ring + a) + b, which differs from
    ring + (a + b) here."""
    topo = jtop.leaf_spine(4, 2, [(0, 1)], uplink_capacity=100.0, latency_ticks=2,
                           fb_delay=4, ring_len=16)
    sched = jtop.null_schedule(topo.links)
    a = 2.0 ** -24
    js = dataclasses.replace(
        jtop.init_shared_fabric(topo),
        forward=jnp.full((1, 1, 2), a, jnp.float32),
        arrive_ring=jnp.zeros((1, 16), jnp.float32).at[0, 3].set(1.0))
    with jax.threefry_partitionable(False):
        js2, _ = jax.jit(lambda s, a_, k: jtop.shared_fabric_tick(topo, sched, s, a_, k))(
            js, jnp.zeros((1, 2), jnp.float32), jax.random.PRNGKey(0))
    ring = np.asarray(js2.arrive_ring)
    assert ring[0, 3] == np.float32(1.0) != np.float32(1.0) + np.float32(2 * a)
    ts = port_state(ttop.SharedFabricState, js, 0)
    ts2, _ = ttop.shared_fabric_tick(port_topo(topo), convert.event_schedule(
        {"cap_scale": np.asarray(sched.cap_scale), "bg_arrivals": np.asarray(sched.bg_arrivals)}),
        ts, torch.zeros((1, 2)), torch.ones(topo.links))
    assert np.array_equal(ring, ts2.arrive_ring.numpy())
    assert np.array_equal(np.asarray(js2.queue), ts2.queue.numpy())


def test_policy_state_update_matches_jitted():
    """Every policy-state block over several feedback ticks, against the
    jitted reference (the penalty decay is one fused multiply-add there)."""
    from repro.net import policy_state as jps
    from repro_torch.net import policy_state as tps

    F, n = 3, 16
    rng = np.random.default_rng(3)
    lat = np.full((F, n), 4.0, np.float32)
    sa = rng.integers(0, 1024, F).astype(np.uint32)
    js = jps.init_policy_state(jps.BLOCKS, (F,), n, latency=jnp.asarray(lat), sa=jnp.asarray(sa))
    ts = tps.init_policy_state(tps.BLOCKS, (F,), n, latency=torch.as_tensor(lat),
                               sa=torch.as_tensor(sa.astype(np.int64)))
    step = jax.jit(jps.update_policy_state)
    for _ in range(12):
        fb = dict(ecn_rate=(rng.random((F, n)) * (rng.random((F, n)) < 0.5)).astype(np.float32),
                  loss_rate=(rng.random((F, n)) * 0.1 * (rng.random((F, n)) < 0.3)).astype(np.float32),
                  rtt_sample=(4 + rng.random((F, n)) * 5).astype(np.float32),
                  seen=rng.random((F, n)) < 0.8)
        js = step(js, **{k: jnp.asarray(v) for k, v in fb.items()})
        ts = tps.update_policy_state(ts, **{k: torch.as_tensor(v) for k, v in fb.items()})
        for name in ("rtt", "penalty", "entropy", "ccw"):
            assert np.array_equal(np.asarray(getattr(js, name)).astype(np.float64),
                                  getattr(ts, name).numpy().astype(np.float64)), name
