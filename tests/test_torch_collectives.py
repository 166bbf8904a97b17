"""The port's collectives (`repro_torch.net.collectives`) against the JAX
package's, on the CPU: the ring on the shared leaf-spine fabric
(`ring_steps_cct_shared`, `sweep_ring_cct_shared`, `allreduce_cct_shared`,
`allgather_cct_shared`, `step_cct_shared`) and on independent path
bundles (`step_cct`, `allreduce_cct`, `allgather_cct`), bit-equal, and
the host helpers (`ideal_step_ticks`, `ettr`, `ring_topology`) exact.
Reference calls run inside ``jax.threefry_partitionable(False)``.  The
reference's `TransportConfig` has no early exit; the port's runs with it,
which leaves every completion field unchanged (the engine's early-exit
invariant), so the comparison also holds early exit to the full
horizon."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.net import collectives as jcol  # noqa: E402
from repro.net import fabric as jfab  # noqa: E402
from repro.net import sender as jsender  # noqa: E402
from repro.net import topology as jtop  # noqa: E402
from repro.net import transport as jtr  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.net import collectives as tcol  # noqa: E402
from repro_torch.net import fabric as tfab  # noqa: E402
from repro_torch.net import sender as tsender  # noqa: E402
from repro_torch.net import transport as ttr  # noqa: E402

WORKERS, SHARD, HORIZON, RATE = 4, 48, 256, 16
POLICIES = ("ECMP", "WAM", "CC_COUPLED")
TOPO_FIELDS = ("route", "capacity", "queue_limit", "ecn_threshold", "latency", "degrade_p",
               "recover_p", "degrade_factor")


def _equal(want, got, what):
    w = np.asarray(want)
    g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert w.dtype == g.dtype and w.shape == g.shape, (what, w.dtype, g.dtype, w.shape, g.shape)
    assert np.array_equal(w, g), what


def _flap_schedule(links, n_leaves=WORKERS, n_spines=4):
    """Spine 0 dark over ticks [20, 80), shared by both packages."""
    cap = np.ones((HORIZON, links), np.float32)
    for leaf in range(n_leaves):
        cap[20:80, jtop.uplink_id(leaf, 0, n_leaves, n_spines)] = 0.0
        cap[20:80, jtop.downlink_id(0, leaf, n_leaves, n_spines)] = 0.0
    return dict(cap_scale=cap, bg_arrivals=np.zeros_like(cap))


@pytest.fixture(scope="module")
def ring():
    jtopo = jcol.ring_topology(WORKERS, uplink_capacity=4.0, degrade_p=0.01)
    ttopo = tcol.ring_topology(WORKERS, uplink_capacity=4.0, degrade_p=0.01)
    arrays = _flap_schedule(jtopo.links)
    jsched = jtop.EventSchedule(cap_scale=jnp.asarray(arrays["cap_scale"]),
                                bg_arrivals=jnp.asarray(arrays["bg_arrivals"]))
    return jtopo, jsched, ttopo, convert.event_schedule(arrays)


def test_ring_topology_equals_reference(ring):
    jtopo, _, ttopo, _ = ring
    for k in TOPO_FIELDS:
        _equal(getattr(jtopo, k), getattr(ttopo, k), k)
    assert (jtopo.fb_delay, jtopo.ring_len) == (ttopo.fb_delay, ttopo.ring_len)


def _spec(mod):
    spec = mod.SenderSpec(rate_cap=RATE, early_exit=True, exit_chunk=16)
    return mod.spec_for_policies(spec, [mod.Policy[p] for p in POLICIES])


def test_sweep_ring_cct_shared_equals_reference(ring):
    """Three policies x 6 ring steps on the flapping ring; each point is
    `ring_steps_cct_shared` with its scalar params."""
    jtopo, jsched, ttopo, tsched = ring
    with jax.threefry_partitionable(False):
        keys = jax.random.split(jax.random.PRNGKey(8), 2 * (WORKERS - 1))
        want = jcol.sweep_ring_cct_shared(
            jtopo, jsched, _spec(jsender),
            jsender.policy_sweep_params([jsender.Policy[p] for p in POLICIES], rate=RATE),
            SHARD, keys, HORIZON)
    tkeys = convert.prng_key(np.asarray(keys))
    got = tcol.sweep_ring_cct_shared(
        ttopo, tsched, _spec(tsender),
        tsender.policy_sweep_params([tsender.Policy[p] for p in POLICIES], rate=RATE),
        SHARD, tkeys, HORIZON, device="cpu")
    for w, g, what in zip(want, got, ("per_step", "finished")):
        _equal(w, g, what)
    one = tcol.ring_steps_cct_shared(ttopo, tsched, _spec(tsender),
                                     tsender.sender_params(tsender.Policy.WAM, rate=RATE),
                                     SHARD, tkeys, HORIZON, device="cpu")
    assert torch.equal(one[0], got[0][1]) and torch.equal(one[1], got[1][1])


@pytest.mark.parametrize("kind", ["allreduce", "allgather"])
def test_ring_collectives_on_the_shared_fabric_equal_reference(ring, kind):
    jtopo, jsched, ttopo, tsched = ring
    cfg_j = jcol.CollectiveConfig(workers=WORKERS, shard_packets=SHARD, horizon=HORIZON)
    cfg_t = tcol.CollectiveConfig(workers=WORKERS, shard_packets=SHARD, horizon=HORIZON)
    tc_j = jtr.TransportConfig(policy=jtr.Policy.WAM, rate=RATE)
    tc_t = ttr.TransportConfig(policy=ttr.Policy.WAM, rate=RATE, early_exit=True)
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(21)
        want = getattr(jcol, f"{kind}_cct_shared")(jtopo, jsched, tc_j, cfg_j, key)
        want_step = jcol.step_cct_shared(jtopo, jsched, tc_j, cfg_j, key)
    tkey = convert.prng_key(np.asarray(key))
    got = getattr(tcol, f"{kind}_cct_shared")(ttopo, tsched, tc_t, cfg_t, tkey, device="cpu")
    for w, g, what in zip(want, got, ("total", "per_step", "finished")):
        _equal(w, g, what)
    _equal(want_step, tcol.step_cct_shared(ttopo, tsched, tc_t, cfg_t, tkey, device="cpu"),
           "step")
    with pytest.raises(ValueError, match="workers"):
        getattr(tcol, f"{kind}_cct_shared")(ttopo, tsched, tc_t,
                                             tcol.CollectiveConfig(workers=3), tkey,
                                             device="cpu")


def _bundle(mod, n=4):
    xp = jnp if mod is jfab else torch
    return mod.FabricParams(
        capacity=xp.asarray([3.0, 2.5, 1.0, 3.0]) if xp is jnp else torch.tensor(
            [3.0, 2.5, 1.0, 3.0]),
        latency=xp.full((n,), 4, dtype=xp.int32),
        queue_limit=xp.full((n,), 12.0), ecn_threshold=xp.full((n,), 5.0),
        degrade_p=xp.full((n,), 0.02), recover_p=xp.full((n,), 0.1),
        degrade_factor=xp.full((n,), 0.1), fb_delay=8, ring_len=64)


@pytest.mark.parametrize("kind", ["allreduce", "allgather"])
def test_ring_collectives_on_path_bundles_equal_reference(kind):
    """Each worker's message on its own bundle with its own key: the
    reference vmaps the workers, the port runs them one after another."""
    cfg_j = jcol.CollectiveConfig(workers=3, shard_packets=32, horizon=128)
    cfg_t = tcol.CollectiveConfig(workers=3, shard_packets=32, horizon=128)
    tc_j = jtr.TransportConfig(policy=jtr.Policy.WAM, rate=8)
    tc_t = ttr.TransportConfig(policy=ttr.Policy.WAM, rate=8, early_exit=True)
    pj, pt = _bundle(jfab), _bundle(tfab)
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(4)
        want = getattr(jcol, f"{kind}_cct")(pj, tc_j, cfg_j, key)
    got = getattr(tcol, f"{kind}_cct")(pt, tc_t, cfg_t, convert.prng_key(np.asarray(key)),
                                       device="cpu")
    for w, g, what in zip(want, got, ("total", "per_step")):
        _equal(w, g, what)
    assert tcol.ideal_step_ticks(pt, 32, 8) == jcol.ideal_step_ticks(pj, 32, 8)
    assert tcol.ideal_step_ticks(pt, 100, 64) == jcol.ideal_step_ticks(pj, 100, 64)
    ccts = np.array(want[1])
    assert tcol.ettr(50.0, torch.as_tensor(ccts), 12.5) == jcol.ettr(50.0, ccts, 12.5)
