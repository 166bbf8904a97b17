"""The port's 3-tier fat-tree against the JAX package: the wiring cases of
tests/test_scaleout.py re-run on the port, `simulate_flows` on a fat-tree
with intra- and inter-pod flows against the jitted reference, and
`single_flow_stepper` under `simulate_message_on`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.net import sender as jsender  # noqa: E402
from repro.net import topology as jtop  # noqa: E402
from repro.net import transport as jtr  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.kernels.link_fold import link_fold, link_fold_plain, link_segments  # noqa: E402
from repro_torch.net import sender as tsender  # noqa: E402
from repro_torch.net import topology as ttop  # noqa: E402
from repro_torch.net import transport as tt  # noqa: E402

TOPO_FIELDS = ("route", "capacity", "queue_limit", "ecn_threshold", "latency", "degrade_p",
               "recover_p", "degrade_factor")
FIELDS = ("cct", "sent_total", "dropped_total", "final_b", "received", "finished",
          "link_served", "link_busy")
PHYS_TIERS = ("leaf_spine_up", "spine_core_up", "core_spine_down", "spine_leaf_down")
RATE = 16
SPEC = tsender.SenderSpec(rate_cap=RATE, early_exit=True)
# 3 pods of 2 leaves: inter-pod flows, and intra-pod ones on the bypass
MIXED = [(0, 2), (1, 5), (2, 0), (0, 1), (4, 5), (3, 2), (5, 1), (2, 4)]


def grid():
    return ttop.FatTreeGrid(n_pods=3, leaves_per_pod=2, spines_per_pod=2, cores_per_spine=2)


def port_topo(t):
    return convert.topology_params({k: np.asarray(getattr(t, k)) for k in TOPO_FIELDS},
                                   fb_delay=t.fb_delay, ring_len=t.ring_len)


def port_sched(s):
    return convert.event_schedule({"cap_scale": np.asarray(s.cap_scale),
                                   "bg_arrivals": np.asarray(s.bg_arrivals)})


@pytest.mark.parametrize("dims", [(3, 2, 2, 2), (8, 4, 2, 2), (2, 1, 3, 1), (4, 3, 1, 5)])
def test_grid_matches_reference(dims):
    """Link counts, the four id helpers and the tier slices, over every
    pod, leaf, spine and core."""
    g, ref = ttop.FatTreeGrid(*dims), jtop.FatTreeGrid(*dims)
    assert (g.n_leaves, g.n_paths, g.links, g.bypass) == (
        ref.n_leaves, ref.n_paths, ref.links, ref.bypass)
    assert g.tier_slices() == ref.tier_slices()
    P, Lp, S, C = dims
    p, lf, s, c = np.meshgrid(np.arange(P), np.arange(Lp), np.arange(S), np.arange(C),
                              indexing="ij")
    for name, args in (("up_leaf_spine", (p, lf, s)), ("up_spine_core", (p, s, c)),
                       ("down_core_spine", (s, c, p)), ("down_spine_leaf", (p, s, lf))):
        assert np.array_equal(getattr(g, name)(*args), getattr(ref, name)(*args)), name
    assert np.array_equal(g.pod_of(np.arange(g.n_leaves)), ref.pod_of(np.arange(g.n_leaves)))


def test_tier_slices_partition_link_axis():
    g = grid()
    sl = g.tier_slices()
    ids = np.concatenate([np.arange(s.start, s.stop) for s in sl.values()])
    assert sorted(ids.tolist()) == list(range(g.links))
    assert sl["bypass"] == slice(g.links - 1, g.links)
    assert g.bypass == g.links - 1
    assert g.n_paths == g.spines_per_pod * g.cores_per_spine


@pytest.mark.parametrize("kw", [
    {}, dict(uplink_capacity=3.5, core_capacity=1.25, downlink_capacity=2.0,
             queue_limit=20.0, ecn_threshold=5.0, latency_ticks=7, intra_latency_ticks=3,
             degrade_p=0.01, recover_p=0.2, degrade_factor=0.1, fb_delay=4, ring_len=64)])
def test_fat_tree_arrays_match_reference(kw):
    want = jtop.fat_tree(3, 2, 2, 2, MIXED, **kw)
    got = ttop.fat_tree(3, 2, 2, 2, MIXED, **kw)
    for k in TOPO_FIELDS:
        w, g = np.asarray(getattr(want, k)), getattr(got, k).numpy()
        assert w.dtype == g.dtype and np.array_equal(w, g), k
    assert (got.fb_delay, got.ring_len) == (want.fb_delay, want.ring_len)


def test_route_hops_land_in_their_tiers():
    g = grid()
    pairs = [(0, 2), (1, 5), (2, 0), (0, 1)]  # 3 inter-pod + 1 intra-pod
    topo = ttop.fat_tree(3, 2, 2, 2, pairs)
    route = topo.route.numpy()
    assert route.shape == (4, len(pairs), g.n_paths)
    sl = g.tier_slices()

    def in_tier(x, name):
        return ((x >= sl[name].start) & (x < sl[name].stop)).all()

    assert in_tier(route[0], "leaf_spine_up")
    assert in_tier(route[3], "spine_leaf_down")
    inter = np.array([g.pod_of(s) != g.pod_of(d) for s, d in pairs])
    assert in_tier(route[1][inter], "spine_core_up")
    assert in_tier(route[2][inter], "core_spine_down")
    assert (route[1][~inter] == g.bypass).all()
    assert (route[2][~inter] == g.bypass).all()
    assert float(topo.capacity[g.bypass]) >= 1e8
    assert float(topo.degrade_p[g.bypass]) == 0.0
    q = np.arange(g.n_paths)
    for f in np.flatnonzero(inter):
        sp_up = (route[0, f] - sl["leaf_spine_up"].start) % g.spines_per_pod
        assert (sp_up == q // g.cores_per_spine).all()


@pytest.mark.parametrize("pairs,dims", [([(0, 0)], (3, 2, 2, 2)), ([(0, 6)], (3, 2, 2, 2)),
                                        ([(0, 1)], (1, 2, 2, 2)), ([(0, 1, 2)], (3, 2, 2, 2)),
                                        ([(0, 1)], (3, 0, 2, 2))])
def test_fat_tree_validation(pairs, dims):
    """Each of the reference's refusals: src == dst, a leaf out of range,
    one pod, malformed pairs, an empty dimension."""
    with pytest.raises(ValueError):
        jtop.fat_tree(*dims, pairs)
    with pytest.raises(ValueError):
        ttop.fat_tree(*dims, pairs)


def test_conservation_across_tiers_inter_pod():
    """Ample capacity, no faults: every delivered packet is served once on
    each of the four physical tiers, and the bypass stays silent."""
    g = grid()
    topo = ttop.fat_tree(3, 2, 2, 2, [(0, 2), (2, 4), (4, 0), (1, 3)], uplink_capacity=64.0,
                         queue_limit=4096.0, ecn_threshold=2048.0)
    sp = tsender.sender_params(tsender.Policy.WAM, rate=RATE)
    r = tsender.run_flows(topo, ttop.null_schedule(topo.links), SPEC, sp, 40,
                          prng.PRNGKey(0), 512, device="cpu")
    assert bool(r.finished.all())
    served = r.link_served.numpy()
    sl = g.tier_slices()
    tier_sums = [float(served[sl[t]].sum()) for t in PHYS_TIERS]
    np.testing.assert_allclose(tier_sums, tier_sums[0], rtol=1e-5)
    assert float(served[sl["bypass"]].sum()) == 0.0
    assert tier_sums[0] > 0


def test_intra_pod_traffic_never_touches_core():
    g = grid()
    topo = ttop.fat_tree(3, 2, 2, 2, [(0, 1), (2, 3), (4, 5)], uplink_capacity=64.0)
    sp = tsender.sender_params(tsender.Policy.WAM, rate=RATE)
    r = tsender.run_flows(topo, ttop.null_schedule(topo.links), SPEC, sp, 40,
                          prng.PRNGKey(1), 512, device="cpu")
    assert bool(r.finished.all())
    served = r.link_served.numpy()
    sl = g.tier_slices()
    assert float(served[sl["spine_core_up"]].sum()) == 0.0
    assert float(served[sl["core_spine_down"]].sum()) == 0.0
    assert float(served[sl["bypass"]].sum()) > 0


def test_link_segments_list_each_links_entries_in_order():
    """The CSR holds each link's flattened (hop, flow, path) indices in
    ascending order, and its padded form is the plain version's index."""
    topo = ttop.fat_tree(3, 2, 2, 2, MIXED)
    seg = link_segments(topo.route, topo.links)
    flat = topo.route.reshape(-1).numpy()
    offsets, index = seg.offsets.numpy(), seg.index.numpy()
    assert offsets[0] == 0 and offsets[-1] == flat.size == seg.entries
    for link in range(topo.links):
        want = np.flatnonzero(flat == link)
        assert np.array_equal(index[offsets[link]:offsets[link + 1]], want), link
        assert np.array_equal(seg.padded[link, :want.size].numpy(), want)
        assert (seg.padded[link, want.size:].numpy() == flat.size).all()
    assert seg.depth == np.bincount(flat).max() == 2 * 3 * 4  # the bypass: 3 intra flows


def test_link_fold_orders_its_adds():
    """The fold adds onto the base in ascending order: values chosen so
    that any other order, or a sum taken first, gives other bits; a link
    with no entries below the deepest still turns -0 into +0, like the
    plain version's padding."""
    route = torch.tensor([[[0, 1]], [[0, 2]], [[0, 0]]], dtype=torch.int32)  # [3, 1, 2]
    seg = link_segments(route, 4)
    vals = torch.tensor([[[1.0, -0.0]], [[2.0 ** -24, 5.0]], [[2.0 ** -24, 0.5]]])
    base = torch.tensor([0.0, -0.0, 7.0, -0.0])
    out = link_fold(vals, seg, base)
    assert torch.equal(out, link_fold_plain(vals, seg, base))
    f = np.float32
    # link 0 reads flat entries 0, 2, 4, 5: each tiny addend rounds away
    want0 = (((f(0.0) + f(1.0)) + f(2.0 ** -24)) + f(2.0 ** -24)) + f(0.5)
    assert out[0].item() == want0 == 1.5
    assert (f(1.0) + (f(2.0 ** -24) + f(2.0 ** -24))) + f(0.5) != want0
    # links 1 and 3 hold fewer entries than the deepest: -0 becomes +0
    assert [str(x) for x in out.tolist()] == ["1.5", "0.0", "12.0", "0.0"]
    assert str(base[3].item()) == "-0.0"


def _jit_run_flows(topo, sched, spec, sp, npk, key, horizon):
    with jax.threefry_partitionable(False):
        return jsender.run_flows(topo, sched, spec, sp, npk, key, horizon)


@pytest.mark.parametrize("early_exit", [False, True], ids=["full", "early-exit"])
@pytest.mark.parametrize("policy", ["WAM", "ECMP", "CC_COUPLED"])
def test_simulate_flows_on_fat_tree_matches_jax(policy, early_exit):
    """Intra- and inter-pod flows on a congested, degrading fat-tree."""
    kw = dict(uplink_capacity=3.0, core_capacity=1.5, queue_limit=12.0, ecn_threshold=4.0,
              degrade_p=0.02, recover_p=0.1)
    topo = jtop.fat_tree(3, 2, 2, 2, MIXED, **kw)
    sched = jtop.null_schedule(topo.links)
    cfg = jtr.TransportConfig(policy=jtr.Policy[policy], rate=RATE)
    spec = jsender.SenderSpec(rate_cap=RATE, early_exit=early_exit, state_blocks=("ccw",))
    want = _jit_run_flows(topo, sched, spec, cfg.params(), 64, jax.random.PRNGKey(9), 384)
    pcfg = tt.TransportConfig(policy=tt.Policy[policy], rate=RATE, early_exit=early_exit)
    got = tt.simulate_flows(port_topo(topo), port_sched(sched), pcfg, 64, prng.PRNGKey(9),
                            384, device="cpu")
    for field in FIELDS:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert w.dtype == g.dtype and np.array_equal(w, g), field
    assert bool(got.finished.all())


@pytest.mark.parametrize("inter", [True, False], ids=["inter-pod", "intra-pod"])
def test_single_flow_stepper_matches_jax(inter):
    pair = [(0, 3)] if inter else [(0, 1)]
    topo = jtop.fat_tree(2, 2, 2, 2, pair, uplink_capacity=2.0, degrade_p=0.05)
    sched = jtop.null_schedule(topo.links)
    cfg = jtr.TransportConfig(policy=jtr.Policy.WAM, rate=8)
    state0, stepper = jtop.single_flow_stepper(topo, sched)

    @jax.jit
    def ref(key):
        return jtr.simulate_message_on(state0, stepper, topo.latency[0], cfg, 48, key, 256,
                                       received_fn=lambda s: s.received[0],
                                       dropped_fn=lambda s: s.dropped[0])

    with jax.threefry_partitionable(False):
        want = ref(jax.random.PRNGKey(2))
    ptopo = port_topo(topo)
    pstate0, pstepper = ttop.single_flow_stepper(ptopo, port_sched(sched))
    got = tt.simulate_message_on(pstate0, pstepper, ptopo.latency[0],
                                 tt.TransportConfig(policy=tt.Policy.WAM, rate=8), 48,
                                 prng.PRNGKey(2), 256, mole_size=ptopo.links)
    for field in FIELDS[:6]:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert w.dtype == g.dtype and np.array_equal(w, g), field
    with pytest.raises(ValueError):
        ttop.single_flow_stepper(ttop.fat_tree(2, 2, 2, 2, [(0, 1), (0, 2)]), port_sched(sched))
