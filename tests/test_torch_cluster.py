"""The port's cluster layer against the JAX package's, on the CPU.

Placements (leaf-spine and pod-aligned), the round table, the solo size
variants and the runner inputs (padded and not) as exact arrays, every
named entry of the cluster scenario library, and the runs at the
reference tests' sizes (two jobs of 4 workers, max_shard 48, horizon
384, with the engine's early exit): `sweep_cluster_rounds_scenarios` over
the overlapped and the staggered placements padded to one round count
(the padded rounds are all silent), `sweep_cluster`, `run_cluster` and
`run_cluster_rounds` with telemetry.  Raw fields are bit-equal; ETTR,
solo ETTR, slowdown, Jain fairness and link utilisation are exact in
float64.  Reference calls are jitted, run inside
``jax.threefry_partitionable(False)`` and made once per module."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.net import cluster as jcl  # noqa: E402
from repro.net import jobs as jjobs  # noqa: E402
from repro.net import scenarios as jscen  # noqa: E402
from repro.net import sender as jsender  # noqa: E402
from repro.net import telemetry as jtel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.net import cluster as tcl  # noqa: E402
from repro_torch.net import jobs as tjobs  # noqa: E402
from repro_torch.net import scenarios as tscen  # noqa: E402
from repro_torch.net import sender as tsender  # noqa: E402
from repro_torch.net import telemetry as ttel  # noqa: E402

WORKERS, RATE, MAX_SHARD, HORIZON = 4, 32, 48, 384
ARCHS = ("xlstm-350m", "qwen3-8b")
POLICIES = ("ECMP", "WAM")
RAW = ("cct", "finished", "link_served", "link_busy")
METRICS = ("ettr", "solo_ettr", "slowdown", "jain", "link_util", "finished")
TOPO_FIELDS = ("route", "capacity", "queue_limit", "ecn_threshold", "latency", "degrade_p",
               "recover_p", "degrade_factor")
STACKED = ("rings_overlapped", "staggered_start")


def _jobs(mod, workers=WORKERS, archs=ARCHS):
    # zero overlap: every tick of communication is exposed
    return [mod.compile_job(a, workers=workers, tp=8, iterations=1, rate=RATE, min_shard=16,
                            max_shard=MAX_SHARD, overlap={"allreduce": 0.0, "allgather": 0.0})
            for a in archs]


def _spec(mod, policies, telemetry=None):
    spec = mod.SenderSpec(rate_cap=RATE, early_exit=True, exit_chunk=16, telemetry=telemetry)
    return mod.spec_for_policies(spec, [mod.Policy[p] for p in policies])


def _sp(mod, policies):
    return mod.policy_sweep_params([mod.Policy[p] for p in policies], rate=RATE)


def _equal(want, got, what):
    w = np.asarray(want)
    g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert w.dtype == g.dtype and w.shape == g.shape, (what, w.dtype, g.dtype, w.shape, g.shape)
    assert np.array_equal(w, g), what


def _same_topo(want, got, what):
    for k in TOPO_FIELDS:
        _equal(getattr(want, k), getattr(got, k), (what, k))
    assert (want.fb_delay, want.ring_len) == (got.fb_delay, got.ring_len)


def _same_cluster(want, got):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.flows, got.rounds) == (want.flows, want.rounds)
    _equal(want.flow_job, got.flow_job, "flow_job")
    _equal(want.flow_pairs(), got.flow_pairs(), "flow_pairs")


def _same_metrics(want, got, what):
    for k in METRICS:
        _equal(getattr(want, k), getattr(got, k), (what, k))
    for w, g in zip(want.step_cct, got.step_cct):
        _equal(w, g, (what, "step_cct"))


def _keys(draws, seed):
    with jax.threefry_partitionable(False):
        keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), draws))
    return keys, convert.prng_key(keys)


@pytest.fixture(scope="module")
def jobs():
    return _jobs(jjobs), _jobs(tjobs)


# --- host: placements, rounds, inputs, the scenario library ----------------

def test_placements_and_topologies_equal_reference(jobs):
    jj, tj = jobs
    hetero = (_jobs(jjobs, 3, ("qwen3-8b",)) + jj, _jobs(tjobs, 3, ("qwen3-8b",)) + tj)
    for (jset, tset) in (jobs, hetero):
        for kw in (dict(colocated=True), dict(colocated=False),
                   dict(colocated=True, start_steps=[0] + [3] * (len(jset) - 1))):
            want, got = jcl.place_jobs(jset, **kw), tcl.place_jobs(tset, **kw)
            _same_cluster(want, got)
            for j in range(len(jset)):
                assert got.job_flows(j) == want.job_flows(j)
            _same_topo(jcl.cluster_topology(want, 4, n_leaves=9, uplink_capacity=4.0),
                       tcl.cluster_topology(got, 4, n_leaves=9, uplink_capacity=4.0), kw)
        for kw in (dict(pack=False), dict(pack=True, start_steps=[0] + [2] * (len(jset) - 1))):
            want, got = jcl.place_jobs_pods(jset, 2, **kw), tcl.place_jobs_pods(tset, 2, **kw)
            _same_cluster(want, got)
            _same_topo(jcl.cluster_fat_tree_topology(want, 2, n_pods=6),
                       tcl.cluster_fat_tree_topology(got, 2, n_pods=6), kw)
    with pytest.raises(ValueError, match="anchors"):
        tcl.place_jobs(tj, start_steps=[1, 0])
    with pytest.raises(ValueError, match="ring"):
        tcl.place_jobs([tjobs.compile_job("qwen3-8b", workers=1)])


def test_round_tables_and_inputs_equal_reference(jobs):
    jj, tj = jobs
    _, sched_j = jscen.job_scenarios(workers=8, horizon=300)["crossjob_background"]
    _, sched_t = tscen.job_scenarios(workers=8, horizon=300)["crossjob_background"]
    for kw in (dict(), dict(start_steps=[0, 5]), dict(start_steps=[0, 20])):
        want_c, got_c = jcl.place_jobs(jj, **kw), tcl.place_jobs(tj, **kw)
        for w, g in zip(jcl.cluster_round_table(want_c), tcl.cluster_round_table(got_c)):
            _equal(w, g, kw)
        sizes = jcl.cluster_round_table(want_c)[0]
        _equal(jcl.solo_size_variants(want_c, sizes), tcl.solo_size_variants(got_c, sizes), kw)
        for rounds in (None, want_c.rounds, want_c.rounds + 5):
            want_s, want_n = jcl.cluster_inputs(want_c, sched_j, 64, rounds)
            got_s, got_n = tcl.cluster_inputs(got_c, sched_t, 64, rounds, device="cpu")
            _equal(want_n, got_n, (kw, rounds))
            _equal(want_s.cap_scale, got_s.cap_scale, (kw, rounds))
            _equal(want_s.bg_arrivals, got_s.bg_arrivals, (kw, rounds))
    with pytest.raises(ValueError, match="rounds"):
        tcl.cluster_inputs(tcl.place_jobs(tj), sched_t, 64, 2)


@pytest.mark.parametrize("kw", [dict(horizon=512),
                                dict(n_spines=3, horizon=200, stagger_steps=2,
                                     straggler_factor=0.5, flap_period=32, flap_spine=2,
                                     oversub_ratio=4.0)], ids=["default", "odd"])
def test_cluster_scenarios_equal_reference(jobs, kw):
    assert tscen.CLUSTER_SCENARIO_NAMES == jscen.CLUSTER_SCENARIO_NAMES
    want, got = jscen.cluster_scenarios(jobs[0], **kw), tscen.cluster_scenarios(jobs[1], **kw)
    assert tuple(got) == tscen.CLUSTER_SCENARIO_NAMES
    for name in want:
        _same_cluster(want[name][0], got[name][0])
        _same_topo(want[name][1], got[name][1], name)
        _equal(want[name][2].cap_scale, got[name][2].cap_scale, name)
        _equal(want[name][2].bg_arrivals, got[name][2].bg_arrivals, name)


def test_jain_and_link_utilization_equal_reference():
    x = np.random.default_rng(1).uniform(0.1, 2.0, (3, 4, 5))
    for axis in (-1, 0):
        assert np.array_equal(jcl.jain_index(x, axis), tcl.jain_index(x, axis))
    topo_j = jscen.job_scenarios(workers=4)["uncontended"][0]
    topo_t = tscen.job_scenarios(workers=4)["uncontended"][0]
    served = np.random.default_rng(2).uniform(0, 50, (2, 6, topo_j.links)).astype(np.float32)
    busy = np.floor(served / 5).astype(np.float32)
    _equal(jcl.link_utilization(topo_j, served, busy),
           tcl.link_utilization(topo_t, torch.as_tensor(served), torch.as_tensor(busy)), "util")


# --- runs --------------------------------------------------------------------

@pytest.fixture(scope="module")
def stacked_runs(jobs):
    """The overlapped and the staggered placements, padded to one round
    count, x ECMP / WAM x one draw through `sweep_cluster_rounds_scenarios`
    in both packages."""
    out = {}
    for mod, cl, jset in ((jscen, jcl, jobs[0]), (tscen, tcl, jobs[1])):
        scens = mod.cluster_scenarios(jset, horizon=512)
        R = max(scens[n][0].rounds for n in STACKED)
        kw = {} if mod is jscen else dict(device="cpu")
        inputs = [cl.cluster_inputs(scens[n][0], scens[n][2], HORIZON, R, **kw)
                  for n in STACKED]
        stack = mod.stack_pytrees
        out[mod] = dict(scens=scens, rounds=R, args=(
            stack([scens[n][1] for n in STACKED]), stack([s for s, _ in inputs])),
            sizes=np.stack([np.asarray(n) for _, n in inputs]))
    keys_np, keys = _keys(1, seed=4)
    with jax.threefry_partitionable(False):
        want = jcl.sweep_cluster_rounds_scenarios(
            *out[jscen]["args"], _spec(jsender, POLICIES), _sp(jsender, POLICIES),
            out[jscen]["sizes"], keys_np, HORIZON)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = tcl.sweep_cluster_rounds_scenarios(
        *out[tscen]["args"], _spec(tsender, POLICIES), _sp(tsender, POLICIES),
        torch.as_tensor(out[tscen]["sizes"]), keys, HORIZON, device="cpu")
    return dict(want=want, got=got, ref=out[jscen], port=out[tscen], keys=(keys_np, keys))


def test_sweep_cluster_rounds_scenarios_equals_reference(stacked_runs):
    want, got = stacked_runs["want"], stacked_runs["got"]
    R, F = stacked_runs["port"]["rounds"], 2 * WORKERS
    assert tuple(got["cct"].shape) == (len(STACKED), len(POLICIES), 1, 3, R, F)
    for k in RAW:
        _equal(want[k], got[k], k)
    assert bool(got["finished"].all())
    # the metrics of each scenario, exact
    for c, name in enumerate(STACKED):
        (wc, wt, _), (gc, gt, _) = (stacked_runs["ref"]["scens"][name],
                                    stacked_runs["port"]["scens"][name])
        _same_metrics(jcl.cluster_metrics(wc, wt, {k: want[k][c] for k in RAW}),
                      tcl.cluster_metrics(gc, gt, {k: got[k][c] for k in RAW}), name)


def test_padded_and_silent_rounds_stay_silent(stacked_runs):
    """The overlapped placement's padded rounds, and every round where no
    job is active (a solo variant's silenced rounds), complete at tick 0
    and leave the link counters at zero."""
    got = stacked_runs["got"]
    sizes = torch.as_tensor(stacked_runs["port"]["sizes"])   # [C, V, R, F]
    silent = (sizes == 0).all(-1)                            # [C, V, R]
    assert bool(silent[0, :, -1].all()), "the overlapped placement is padded"
    sel = silent[:, None, None].expand(got["cct"].shape[:-1])
    assert bool((got["cct"][sel] == 0).all()) and bool(got["finished"][sel].all())
    assert not bool(got["link_served"][sel].any()) and not bool(got["link_busy"][sel].any())


def test_sweep_cluster_equals_reference(jobs):
    """`sweep_cluster` on the straggler scenario: every metric exact."""
    keys_np, keys = _keys(1, seed=9)
    wc, wt, ws = jscen.cluster_scenarios(jobs[0], horizon=512)["straggler_job_a"]
    gc, gt, gs = tscen.cluster_scenarios(jobs[1], horizon=512)["straggler_job_a"]
    with jax.threefry_partitionable(False):
        want = jcl.sweep_cluster(wt, ws, _spec(jsender, POLICIES), _sp(jsender, POLICIES), wc,
                                 keys_np, HORIZON)
    got = tcl.sweep_cluster(gt, gs, _spec(tsender, POLICIES), _sp(tsender, POLICIES), gc, keys,
                            HORIZON, device="cpu")
    _same_metrics(want, got, "straggler_job_a")
    assert got.ettr.shape == (len(POLICIES), 1, 2) and bool(got.finished.all())
    # flow-sharded over two ranks: every metric equal
    _same_metrics(want, tcl.sweep_cluster(gt, gs, _spec(tsender, POLICIES),
                                          _sp(tsender, POLICIES), gc, keys, HORIZON,
                                          mesh=tsender.flow_mesh(2, device="cpu")),
                  "straggler_job_a over two ranks")


def test_run_cluster_disjoint_slowdown_is_one(jobs):
    """On disjoint leaves the paired solo runs reproduce the contended
    runs exactly (slowdown 1, Jain 1), in both packages alike."""
    keys_np, keys = _keys(1, seed=2)
    wc, wt, ws = jscen.cluster_scenarios(jobs[0], horizon=512)["uncontended"]
    gc, gt, gs = tscen.cluster_scenarios(jobs[1], horizon=512)["uncontended"]
    wam_j = jsender.sender_params(jsender.Policy.WAM, rate=RATE)
    with jax.threefry_partitionable(False):
        want = jcl.run_cluster(wt, ws, _spec(jsender, ("WAM",)), wam_j, wc, keys_np[0], HORIZON)
    got = tcl.run_cluster(gt, gs, _spec(tsender, ("WAM",)),
                          tsender.sender_params(tsender.Policy.WAM, rate=RATE), gc, keys[0],
                          HORIZON, device="cpu")
    _same_metrics(want, got, "uncontended")
    assert np.array_equal(got.slowdown, np.ones(2)) and got.jain == 1.0


def test_run_cluster_rounds_with_telemetry_equals_reference(jobs):
    """WAM on the flap during the overlap with telemetry: raw fields and
    every frame leaf (round axis leading, then the variant) equal."""
    keys_np, keys = _keys(1, seed=6)
    tel = dict(stride=4, window=16)
    wc, wt, ws = jscen.cluster_scenarios(jobs[0], horizon=512)["flap_during_overlap"]
    gc, gt, gs = tscen.cluster_scenarios(jobs[1], horizon=512)["flap_during_overlap"]
    scheds_j, sizes_j = jcl.cluster_inputs(wc, ws, HORIZON)
    scheds_t, sizes_t = tcl.cluster_inputs(gc, gs, HORIZON, device="cpu")
    with jax.threefry_partitionable(False):
        want = jcl.run_cluster_rounds(
            wt, scheds_j, _spec(jsender, ("WAM",), jtel.TelemetrySpec(**tel)),
            jsender.sender_params(jsender.Policy.WAM, rate=RATE), sizes_j, keys_np[0], HORIZON)
    got = tcl.run_cluster_rounds(
        gt, scheds_t, _spec(tsender, ("WAM",), ttel.TelemetrySpec(**tel)),
        tsender.sender_params(tsender.Policy.WAM, rate=RATE), sizes_t, keys[0], HORIZON,
        device="cpu")
    for k in RAW:
        _equal(want[k], got[k], k)
    want_f = convert.telemetry_frame({f.name: np.asarray(getattr(want["telemetry"], f.name))
                                      for f in dataclasses.fields(want["telemetry"])})
    got_f = got["telemetry"]
    for f in dataclasses.fields(got_f):
        w, g = getattr(want_f, f.name), getattr(got_f, f.name)
        assert w.dtype == g.dtype and w.shape == g.shape and torch.equal(w, g), f.name
    assert tuple(got_f.count.shape) == (gc.rounds, 3)
