"""The port's one-device sweeps against the JAX package's jitted sweeps:
scenario families x policies x draws with telemetry on, `sweep_message`
slice by slice, and the stacked sender params."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.net import fabric as jfab  # noqa: E402
from repro.net import scenarios as jscen  # noqa: E402
from repro.net import sender as jsender  # noqa: E402
from repro.net import telemetry as jtel  # noqa: E402
from repro.net import topology as jtop  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.net import scenarios as tscen  # noqa: E402
from repro_torch.net import sender as tsender  # noqa: E402
from repro_torch.net import telemetry as ttel  # noqa: E402
from repro_torch.net import topology as ttop  # noqa: E402

POLICIES = ("ECMP", "WAM", "CC_COUPLED")
RATE, HORIZON, N_PACKETS = 16, 256, 32
TEL = dict(stride=4, window=64)
RESULT_FIELDS = ("cct", "sent_total", "dropped_total", "final_b", "received", "finished",
                 "link_served", "link_busy")


def family(name, scen, top):
    """The pair family, or the fat-tree family (4 pods x 2 leaves x 2
    spines x 2 cores) plus one placement that mixes intra- and inter-pod
    flows, so the bypass link carries traffic."""
    if name == "pair":
        return scen.stack_scenarios(list(scen.pair_scenarios(flows=4, horizon=HORIZON).values()))
    flows = 16
    scens = list(scen.fat_tree_scenarios(flows=flows, n_pods=4, horizon=HORIZON).values())
    mixed = [(2 * (f % 4), 2 * (f % 4) + 1) if f % 2 else (f % 8, (f + 3) % 8)
             for f in range(flows)]
    topo = top.fat_tree(4, 2, 2, 2, mixed, uplink_capacity=8.0)
    scens.append((topo, top.null_schedule(topo.links)))
    return scen.stack_scenarios(scens)


def _spec(mod, tmod):
    spec = mod.SenderSpec(rate_cap=RATE, early_exit=True, telemetry=tmod.TelemetrySpec(**TEL))
    return mod.spec_for_policies(spec, [mod.Policy[p] for p in POLICIES])


@pytest.mark.parametrize("name", ["pair", "fat_tree"])
def test_sweep_flows_scenarios_matches_reference(name):
    jtopos, jscheds = family(name, jscen, jtop)
    sp = jsender.policy_sweep_params([jsender.Policy[p] for p in POLICIES], rate=RATE)
    with jax.threefry_partitionable(False):
        keys = jax.random.split(jax.random.PRNGKey(5), 2)
        want_r, want_f = jsender.sweep_flows_scenarios(
            jtopos, jscheds, _spec(jsender, jtel), sp, N_PACKETS, keys, HORIZON)
    ttopos, tscheds = family(name, tscen, ttop)
    tsp = tsender.policy_sweep_params([tsender.Policy[p] for p in POLICIES], rate=RATE)
    got_r, got_f = tsender.sweep_flows_scenarios(
        ttopos, tscheds, _spec(tsender, ttel), tsp, N_PACKETS,
        convert.prng_key(np.asarray(keys)), HORIZON, device="cpu")
    C = int(ttopos.route.shape[0])
    for field in RESULT_FIELDS:
        w, g = np.asarray(getattr(want_r, field)), getattr(got_r, field).numpy()
        assert w.dtype == g.dtype and w.shape == g.shape and w.shape[:3] == (C, 3, 2), field
        assert np.array_equal(w, g), field
    assert got_r.ticks_run.shape == (C, 3, 2)
    want_f = convert.telemetry_frame({f.name: np.asarray(getattr(want_f, f.name))
                                      for f in dataclasses.fields(want_f)})
    for f in dataclasses.fields(got_f):
        w, g = getattr(want_f, f.name), getattr(got_f, f.name)
        assert w.dtype == g.dtype and w.shape == g.shape and torch.equal(w, g), f.name
    # a slice is the unbatched run, frame and all
    c, p, d = C - 1, 1, 1
    topo_c = dataclasses.replace(ttopos, **{
        k.name: getattr(ttopos, k.name)[c] for k in dataclasses.fields(ttopos)
        if torch.is_tensor(getattr(ttopos, k.name))})
    sched_c = ttop.EventSchedule(cap_scale=tscheds.cap_scale[c],
                                 bg_arrivals=tscheds.bg_arrivals[c])
    one_r, one_f = tsender.run_flows(
        topo_c, sched_c, _spec(tsender, ttel),
        tsender.sender_params(tsender.Policy[POLICIES[p]], rate=RATE), N_PACKETS,
        convert.prng_key(np.asarray(keys[d])), HORIZON, device="cpu")
    for field in RESULT_FIELDS + ("ticks_run",):
        assert torch.equal(getattr(one_r, field), getattr(got_r, field)[c, p, d]), field
    sliced = ttel.frame_select(got_f, (c, p, d))
    for f in dataclasses.fields(one_f):
        assert torch.equal(getattr(one_f, f.name), getattr(sliced, f.name)), f.name


def test_sweep_flows_matches_reference():
    """One scenario, two policies, two draws, without telemetry."""
    topo = jtop.leaf_spine(4, 4, [(0, 1), (2, 3), (1, 0)], uplink_capacity=2.0,
                           degrade_p=0.02)
    sched = jtop.null_schedule(topo.links)
    spec = jsender.SenderSpec(rate_cap=8, early_exit=True)
    sp = jsender.policy_sweep_params((jsender.Policy.ECMP, jsender.Policy.WAM), rate=8)
    with jax.threefry_partitionable(False):
        keys = jax.random.split(jax.random.PRNGKey(3), 2)
        want = jsender.sweep_flows(topo, sched, spec, sp, 24, keys, 128)
    ttopo = convert.topology_params({k: np.asarray(getattr(topo, k)) for k in (
        "route", "capacity", "queue_limit", "ecn_threshold", "latency", "degrade_p",
        "recover_p", "degrade_factor")}, fb_delay=topo.fb_delay, ring_len=topo.ring_len)
    got = tsender.sweep_flows(ttopo, ttop.null_schedule(topo.links),
                              tsender.SenderSpec(rate_cap=8, early_exit=True),
                              tsender.policy_sweep_params((tsender.Policy.ECMP,
                                                           tsender.Policy.WAM), rate=8),
                              24, convert.prng_key(np.asarray(keys)), 128, device="cpu")
    for field in RESULT_FIELDS:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert w.dtype == g.dtype and w.shape == g.shape and np.array_equal(w, g), field
    assert got.ticks_run.shape == (2, 2)


def _bundle(n=4):
    import jax.numpy as jnp
    return jfab.FabricParams(
        capacity=jnp.full((n,), 3.0), latency=jnp.full((n,), 4, jnp.int32),
        queue_limit=jnp.full((n,), 12.0), ecn_threshold=jnp.full((n,), 5.0),
        degrade_p=jnp.full((n,), 0.03), recover_p=jnp.full((n,), 0.1),
        degrade_factor=jnp.full((n,), 0.2), fb_delay=8, ring_len=64)


def _port_bundle(jp=None):
    jp = _bundle() if jp is None else jp
    return convert.fabric_params({k: np.asarray(getattr(jp, k)) for k in (
        "capacity", "latency", "queue_limit", "ecn_threshold", "degrade_p", "recover_p",
        "degrade_factor")}, fb_delay=jp.fb_delay, ring_len=jp.ring_len)


def test_sweep_message_matches_reference_and_run_message():
    jp = _bundle()
    pols = ("ECMP", "RAND_ADAPTIVE", "WAM")
    spec = jsender.SenderSpec(rate_cap=8, coded=False)
    sp = jsender.policy_sweep_params([jsender.Policy[p] for p in pols], rate=8)
    with jax.threefry_partitionable(False):
        keys = jax.random.split(jax.random.PRNGKey(11), 2)
        want = jsender.sweep_message(jp, spec, sp, 64, keys, 192)
    tp = _port_bundle(jp)
    tspec = tsender.SenderSpec(rate_cap=8, coded=False)
    tsp = tsender.policy_sweep_params([tsender.Policy[p] for p in pols], rate=8)
    tkeys = convert.prng_key(np.asarray(keys))
    got = tsender.sweep_message(tp, tspec, tsp, 64, tkeys, 192, device="cpu")
    for field in RESULT_FIELDS[:6]:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert w.dtype == g.dtype and w.shape == g.shape and np.array_equal(w, g), field
    for i, p in enumerate(pols):
        for d in range(2):
            one = tsender.run_message(tp, tspec, tsender.sender_params(tsender.Policy[p], rate=8),
                                      64, tkeys[d], 192, device="cpu")
            for field in RESULT_FIELDS + ("ticks_run",):
                assert torch.equal(getattr(one, field), getattr(got, field)[i, d]), (p, d, field)


@pytest.mark.parametrize("policies,kw", [
    (None, dict(rate=32)),
    (("ECMP", "WAM"), dict(rate=24, cwnd=64.0, code_overhead=0.1, ctrl_interval=2,
                           seed=(7, 2**31 + 9))),
    (("PRIME", "STRACK", "CC_COUPLED"), dict(seed=(5, 3)))])
def test_stacked_params_match_reference(policies, kw):
    if policies is None:
        want, got = jsender.policy_sweep_params(**kw), tsender.policy_sweep_params(**kw)
    else:
        want = jsender.policy_sweep_params([jsender.Policy[p] for p in policies], **kw)
        got = tsender.policy_sweep_params([tsender.Policy[p] for p in policies], **kw)
    arrays = {f.name: np.asarray(getattr(want, f.name)) for f in dataclasses.fields(want)}
    for name, w in arrays.items():
        g = getattr(got, name).numpy()
        assert g.shape == w.shape and np.array_equal(g.astype(w.dtype), w), name
        assert g.dtype == (np.int64 if name in ("sa", "sb") else w.dtype), name
    singles = [tsender.sender_params(tsender.Policy[p], **kw) for p in (
        policies or [q.name for q in tsender.BASELINE_POLICIES])]
    stacked = tsender.stack_params(singles)
    for name in arrays:
        assert torch.equal(getattr(stacked, name), getattr(got, name)), name
    with pytest.raises(ValueError):
        tsender.stack_params([])
    with pytest.raises(ValueError):
        tsender.sweep_message(_port_bundle(), tsender.SenderSpec(), singles[0], 8,
                              convert.prng_key(np.zeros((1, 2), np.uint32)), 8, device="cpu")
