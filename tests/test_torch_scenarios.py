"""The port's scenario library against the JAX package: every named pair
and fat-tree scenario's topology and event schedule, the leaf-spine
constructors, and stacking (including a ragged horizon's extension)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.net import scenarios as js  # noqa: E402
from repro_torch.net import scenarios as ts  # noqa: E402

TOPO_FIELDS = ("route", "capacity", "queue_limit", "ecn_threshold", "latency", "degrade_p",
               "recover_p", "degrade_factor")
SCHED_FIELDS = ("cap_scale", "bg_arrivals")


def assert_same(want, got, what):
    for obj_w, obj_g, fields in ((want[0], got[0], TOPO_FIELDS), (want[1], got[1], SCHED_FIELDS)):
        for k in fields:
            w, g = np.asarray(getattr(obj_w, k)), getattr(obj_g, k).numpy()
            assert w.dtype == g.dtype and w.shape == g.shape, (what, k)
            assert np.array_equal(w, g), (what, k)
    assert (want[0].fb_delay, want[0].ring_len) == (got[0].fb_delay, got[0].ring_len), what


PAIR_KW = [dict(flows=4, horizon=256), dict(flows=6, n_spines=3, horizon=100, bg_seed=3,
                                            storm_start=5, flap_period=20, bg_load=0.3)]
FAT_KW = [dict(flows=64, n_pods=4, horizon=256),
          dict(flows=48, n_pods=8, leaves_per_pod=4, spines_per_pod=2, cores_per_spine=2,
               horizon=96, link_capacity=32.0, host_rate=64.0, flap_plane=1)]


@pytest.mark.parametrize("kw", PAIR_KW, ids=["small", "odd"])
@pytest.mark.parametrize("name", js.PAIR_SCENARIO_NAMES)
def test_pair_scenarios_match_reference(name, kw):
    assert ts.PAIR_SCENARIO_NAMES == js.PAIR_SCENARIO_NAMES
    assert_same(js.pair_scenarios(**kw)[name], ts.pair_scenarios(**kw)[name], name)


@pytest.mark.parametrize("kw", FAT_KW, ids=["small", "scaleout-grid"])
@pytest.mark.parametrize("name", js.FAT_TREE_SCENARIO_NAMES)
def test_fat_tree_scenarios_match_reference(name, kw):
    assert ts.FAT_TREE_SCENARIO_NAMES == js.FAT_TREE_SCENARIO_NAMES
    assert_same(js.fat_tree_scenarios(**kw)[name], ts.fat_tree_scenarios(**kw)[name], name)


@pytest.mark.parametrize("name,kw", [
    ("incast", dict(k=5, n_spines=3)), ("oversubscription", dict(ratio=3.0, flows=3)),
    ("link_flap", dict(flows=3, period=16, duty=0.25, spine=1, horizon=70)),
    ("straggler_worker", dict(workers=5, factor=0.5, straggler=2)),
    ("pfc_storm", dict(flows=3, start=4, spread=6, duration=30, horizon=64)),
    ("crossjob_background", dict(flows=3, load=0.7, burst_len=5, gap_len=7, horizon=50, seed=4)),
    ("two_path_whack", dict(t_down=10, t_up=30, horizon=64)),
])
def test_named_constructors_match_reference(name, kw):
    ctor = js.two_path_whack if name == "two_path_whack" else js.SCENARIOS[name]
    port = ts.two_path_whack if name == "two_path_whack" else ts.SCENARIOS[name]
    assert_same(ctor(**kw), port(**kw), name)


@pytest.mark.parametrize("family", ["pair", "fat_tree"])
def test_stack_scenarios_matches_reference(family):
    if family == "pair":
        want = js.stack_scenarios(list(js.pair_scenarios(flows=4, horizon=256).values()))
        got = ts.stack_scenarios(list(ts.pair_scenarios(flows=4, horizon=256).values()))
    else:
        want = js.stack_scenarios(list(js.fat_tree_scenarios(flows=16, horizon=64).values()))
        got = ts.stack_scenarios(list(ts.fat_tree_scenarios(flows=16, horizon=64).values()))
    assert_same(want, got, family)


def test_stack_scenarios_extends_a_ragged_horizon():
    """Schedules of horizons 1, 40 and 64 stack to 64 rows, each extended
    by repeating its last row, as the reference does."""
    kw = dict(flows=3, n_spines=2)
    want = js.stack_scenarios([js.link_flap(**kw, period=16, horizon=40),
                               js.oversubscription(ratio=2.0, flows=3, n_spines=2),
                               js.pfc_storm(**kw, start=3, spread=5, duration=20, horizon=64)])
    got = ts.stack_scenarios([ts.link_flap(**kw, period=16, horizon=40),
                              ts.oversubscription(ratio=2.0, flows=3, n_spines=2),
                              ts.pfc_storm(**kw, start=3, spread=5, duration=20, horizon=64)])
    assert got[1].cap_scale.shape == (3, 64, 24)
    assert torch.equal(got[1].cap_scale[0, 40:], got[1].cap_scale[0, 39:40].expand(24, 24))
    assert_same(want, got, "ragged")


def test_stack_refusals():
    """Differing statics or shapes do not stack; nor does nothing."""
    a = ts.incast(k=3)
    with pytest.raises(ValueError):
        ts.stack_scenarios([a, ts.incast(k=3, fb_delay=4)])
    with pytest.raises(ValueError):
        ts.stack_scenarios([a, ts.incast(k=4)])
    with pytest.raises(ValueError):
        ts.stack_scenarios([])
    with pytest.raises(ValueError):
        ts.stack_pytrees([])
    with pytest.raises(ValueError):
        ts.fat_tree_scenarios(flows=8, n_pods=1)
