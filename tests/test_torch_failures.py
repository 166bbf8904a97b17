"""The port's correlated failure processes (`repro_torch.net.failures`) and
the four correlated scenario families against the JAX package's: SRLG
membership, the compiled capacity schedules, the Hawkes draws from
numpy's generator, the validation errors, and every named entry of the
pair, fat-tree, job and cluster families (topology arrays, event
schedules and placements), all exactly equal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.net import failures as jf  # noqa: E402
from repro.net import jobs as jjobs  # noqa: E402
from repro.net import scenarios as jscen  # noqa: E402
from repro.net import topology as jtop  # noqa: E402
from repro_torch.net import failures as tf  # noqa: E402
from repro_torch.net import jobs as tjobs  # noqa: E402
from repro_torch.net import scenarios as tscen  # noqa: E402
from repro_torch.net import topology as ttop  # noqa: E402

TOPO_FIELDS = ("route", "capacity", "queue_limit", "ecn_threshold", "latency", "degrade_p",
               "recover_p", "degrade_factor")
GRIDS = [(2, 2, 2, 2), (4, 2, 2, 2), (3, 4, 3, 2), (8, 4, 2, 2)]


def _equal(want, got, what):
    w = np.asarray(want)
    g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert w.dtype == g.dtype and w.shape == g.shape, (what, w.dtype, g.dtype, w.shape, g.shape)
    assert np.array_equal(w, g), what


def _groups_equal(want, got):
    assert list(want) == list(got) if isinstance(want, dict) else len(want) == len(got)
    items = zip(want.values(), got.values()) if isinstance(want, dict) else zip(want, got)
    for w, g in items:
        assert (w.name, w.links) == (g.name, g.links)
        _equal(w.ids, g.ids, w.name)


def test_exports_equal_reference():
    assert tf.__all__ == jf.__all__
    assert tscen.CORRELATED_SCENARIOS.keys() == jscen.CORRELATED_SCENARIOS.keys()


def test_link_group_and_events_validate_like_reference():
    assert tf.LinkGroup("g", (5, 1, 5, 3)).links == jf.LinkGroup("g", (5, 1, 5, 3)).links
    for mod in (jf, tf):
        with pytest.raises(ValueError, match="empty"):
            mod.LinkGroup("g", ())
        with pytest.raises(ValueError, match="negative"):
            mod.LinkGroup("g", (-1, 2))
        g = mod.LinkGroup("g", (0, 3))
        with pytest.raises(ValueError, match="empty"):
            mod.SRLGEvent(g, 5, 5)
        with pytest.raises(ValueError, match="severity"):
            mod.SRLGEvent(g, 0, 4, 0.0)
        with pytest.raises(ValueError, match="links="):
            mod.srlg_caps(3, 16, [mod.SRLGEvent(g, 0, 4)])
        with pytest.raises(ValueError, match="never fire"):
            mod.srlg_caps(4, 16, [mod.SRLGEvent(g, 16, 20)])


@pytest.mark.parametrize("n_leaves,n_spines", [(2, 2), (4, 4), (16, 4), (5, 3)])
def test_leaf_spine_groups_and_waves_equal_reference(n_leaves, n_spines):
    _groups_equal(jf.leaf_spine_srlgs(n_leaves, n_spines), tf.leaf_spine_srlgs(n_leaves, n_spines))
    for kw in (dict(), dict(root_leaf=n_leaves - 1, root_spine=n_spines - 1)):
        _groups_equal(jf.leaf_spine_cascade_waves(n_leaves, n_spines, **kw),
                      tf.leaf_spine_cascade_waves(n_leaves, n_spines, **kw))


@pytest.mark.parametrize("grid", GRIDS, ids=[str(g) for g in GRIDS])
def test_fat_tree_groups_and_waves_equal_reference(grid):
    jg, tg = jtop.FatTreeGrid(*grid), ttop.FatTreeGrid(*grid)
    _groups_equal(jf.fat_tree_srlgs(jg), tf.fat_tree_srlgs(tg))
    for kw in (dict(), dict(root_pod=grid[0] - 1, root_spine=grid[2] - 1)):
        _groups_equal(jf.fat_tree_cascade_waves(jg, **kw), tf.fat_tree_cascade_waves(tg, **kw))


def test_compiled_schedules_equal_reference():
    jgroups = list(jf.leaf_spine_srlgs(6, 3).values())
    tgroups = list(tf.leaf_spine_srlgs(6, 3).values())
    L, H = 36, 200
    for sev in (1.0, 0.75, 0.3):
        _equal(jf.srlg_caps(L, H, [jf.SRLGEvent(jgroups[0], 10, 90, sev),
                                  jf.SRLGEvent(jgroups[1], 50, 300, 0.5)]),
               tf.srlg_caps(L, H, [tf.SRLGEvent(tgroups[0], 10, 90, sev),
                                  tf.SRLGEvent(tgroups[1], 50, 300, 0.5)]), sev)
    jw, tw = jf.leaf_spine_cascade_waves(6, 3), tf.leaf_spine_cascade_waves(6, 3)
    for kw in (dict(start=20, duration=100, hop_delay=16, severity=1.0, decay=0.6),
               dict(start=5, duration=30, hop_delay=20, severity=0.8, decay=1.0),
               dict(start=190, duration=50, hop_delay=0)):
        _equal(jf.cascade_caps(L, H, jw, **kw), tf.cascade_caps(L, H, tw, **kw), kw)
        onset = dict(start=kw["start"], duration=kw["duration"], hop_delay=kw["hop_delay"])
        _equal(jf.cascade_onset_ticks(jw, **onset), tf.cascade_onset_ticks(tw, **onset), kw)
    for kw in (dict(mu=8 / 2048, branching=0.7, tau=32.0, seed=3),
               dict(mu=24 / 512, branching=0.5, tau=16.0, seed=11),
               dict(mu=0.01, branching=0.0, tau=1.0, seed=0)):
        H2 = 2048 if kw["seed"] == 3 else 512
        want, got = jf.hawkes_times(H2, **kw), tf.hawkes_times(H2, **kw)
        _equal(want, got, kw)
        for flap_kw in (dict(flap_len=24, seed=0), dict(flap_len=3, severity=0.5, seed=7)):
            _equal(jf.burst_flap_caps(L, H2, jgroups, want, **flap_kw),
                   tf.burst_flap_caps(L, H2, tgroups, got, **flap_kw), flap_kw)
    a = np.random.default_rng(0).uniform(0, 1, (H, L)).astype(np.float32)
    b = jf.cascade_caps(L, H, jw, start=3, duration=60)
    _equal(jf.compose_caps(a, b, a), tf.compose_caps(a, b, a), "compose")


def test_process_validation_like_reference():
    waves = tf.leaf_spine_cascade_waves(4, 4)
    g = tf.LinkGroup("g", (0, 1))
    for kw, match in ((dict(start=0, duration=0), "duration"),
                      (dict(start=0, duration=8, hop_delay=-1), "hop_delay"),
                      (dict(start=0, duration=8, severity=0.0), "severity"),
                      (dict(start=0, duration=8, decay=1.5), "decay")):
        with pytest.raises(ValueError, match=match):
            tf.cascade_caps(32, 64, waves, **kw)
    for kw, match in ((dict(horizon=0, mu=0.1), "horizon"), (dict(horizon=64, mu=0.0), "mu"),
                      (dict(horizon=64, mu=0.1, branching=1.0), "branching"),
                      (dict(horizon=64, mu=0.1, tau=0.0), "tau"),
                      (dict(horizon=4096, mu=0.5, branching=0.9, max_events=64), "max_events")):
        with pytest.raises(ValueError, match=match):
            tf.hawkes_times(**kw)
    with pytest.raises(ValueError, match="flap_len"):
        tf.burst_flap_caps(4, 64, [g], np.array([3]), flap_len=0)
    with pytest.raises(ValueError, match="target group"):
        tf.burst_flap_caps(4, 64, [], np.array([3]))
    with pytest.raises(ValueError, match="shapes differ"):
        tf.compose_caps(np.ones((4, 2), np.float32), np.ones((4, 3), np.float32))


# --- the four correlated scenario families ---------------------------------

def _same_scenario(want, got, what):
    *wc, wt, ws = want
    *gc, gt, gs = got
    if wc:
        assert dataclasses.asdict(gc[0]) == dataclasses.asdict(wc[0]), what
    for k in TOPO_FIELDS:
        _equal(getattr(wt, k), getattr(gt, k), (what, k))
    assert (wt.fb_delay, wt.ring_len) == (gt.fb_delay, gt.ring_len)
    _equal(ws.cap_scale, gs.cap_scale, (what, "cap_scale"))
    _equal(ws.bg_arrivals, gs.bg_arrivals, (what, "bg_arrivals"))


def _cluster_jobs(mod):
    return [mod.compile_job(a, workers=4, tp=8, iterations=1, max_shard=48)
            for a in ("xlstm-350m", "qwen3-8b")]


FAMILIES = {
    "pair": [dict(flows=4, horizon=256),
             dict(flows=6, n_spines=3, horizon=300, derate_severity=0.5, cascade_hop_delay=7,
                  cascade_decay=0.9, flap_mu=0.02, flap_branching=0.4, flap_tau=5.0,
                  flap_len=9, flap_seed=5)],
    "fat_tree": [dict(flows=16, horizon=256),
                 dict(flows=24, n_pods=3, leaves_per_pod=4, spines_per_pod=3,
                      cores_per_spine=2, horizon=512, derate_severity=0.9, flap_seed=2)],
    "job": [dict(workers=4, horizon=256),
            dict(workers=5, n_spines=3, horizon=400, cascade_hop_delay=3, flap_seed=9)],
    "cluster": [dict(horizon=256), dict(n_spines=3, horizon=400, cascade_decay=0.3,
                                        flap_seed=1)],
}


@pytest.mark.parametrize("case", [0, 1], ids=["small", "odd"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_correlated_families_equal_reference(family, case):
    names = f"CORRELATED_{family.upper()}_SCENARIO_NAMES"
    assert getattr(tscen, names) == getattr(jscen, names)
    kw = FAMILIES[family][case]
    jargs = (_cluster_jobs(jjobs),) if family == "cluster" else ()
    targs = (_cluster_jobs(tjobs),) if family == "cluster" else ()
    want = jscen.CORRELATED_SCENARIOS[family](*jargs, **kw)
    got = tscen.CORRELATED_SCENARIOS[family](*targs, **kw)
    assert tuple(got) == getattr(tscen, names)
    for name in want:
        _same_scenario(want[name], got[name], (family, name))
