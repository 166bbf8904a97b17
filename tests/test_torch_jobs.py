"""The port's job layer against the JAX package's, on the CPU.

Every arch's `compile_job` schedule (equal dataclasses, step tables and
packet totals, not close ones), the scenario rows a step reads
(`scheduled_events`, `job_step_inputs`), every named entry of the job
scenario library, and the runs: the stacked job library (two models, two
policies) through `sweep_job_steps_scenarios`, `sweep_job` on the
correlated library's spine outage over four policies and two draws,
`run_job` with telemetry, and `run_flows_sized` with size vectors that
hold zeros, at the reference tests' sizes (workers 4, max_shard 48,
horizon 384, with the engine's early exit).  Raw fields are bit-equal and every derived ETTR and
exposed tick count exact in float64.  Reference calls are jitted, run
inside ``jax.threefry_partitionable(False)`` and made once per module."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.net import jobs as jjobs  # noqa: E402
from repro.net import scenarios as jscen  # noqa: E402
from repro.net import sender as jsender  # noqa: E402
from repro.net import telemetry as jtel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.net import jobs as tjobs  # noqa: E402
from repro_torch.net import scenarios as tscen  # noqa: E402
from repro_torch.net import sender as tsender  # noqa: E402
from repro_torch.net import telemetry as ttel  # noqa: E402

WORKERS, RATE, MAX_SHARD, HORIZON = 4, 32, 48, 384
ARCHS = ("xlstm-350m", "qwen3-8b")
POLICIES = ("ECMP", "WAM")
SWEEP_POLICIES = ("ECMP", "WAM", "RAND_ADAPTIVE", "CC_COUPLED")
TOPO_FIELDS = ("route", "capacity", "queue_limit", "ecn_threshold", "latency", "degrade_p",
               "recover_p", "degrade_factor")
SCHED_FIELDS = ("cap_scale", "bg_arrivals")


def _jobs(mod, iterations=1, **kw):
    return [mod.compile_job(a, workers=WORKERS, tp=8, iterations=iterations, rate=RATE,
                            min_shard=16, max_shard=MAX_SHARD, **kw) for a in ARCHS]


def _spec(mod, policies, telemetry=None):
    spec = mod.SenderSpec(rate_cap=RATE, early_exit=True, exit_chunk=16, telemetry=telemetry)
    return mod.spec_for_policies(spec, [mod.Policy[p] for p in policies])


def _library(mod, horizon=256):
    """The job library (a storm of 96 ticks, so every step settles within
    the horizon) and the correlated-job library, whose events begin at
    horizon / 4, mid-job: one ring topology."""
    scens = dict(mod.job_scenarios(workers=WORKERS, horizon=horizon, storm_duration=96))
    scens.update({f"correlated/{k}": v for k, v in
                  mod.correlated_job_scenarios(workers=WORKERS, horizon=horizon).items()})
    return scens


def _stacked(scens):
    """The job library's entries, which the stacked sweep runs."""
    return {k: v for k, v in scens.items() if not k.startswith("correlated/")}


def _equal(want, got, what):
    w, g = np.asarray(want), got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert w.dtype == g.dtype and w.shape == g.shape, (what, w.dtype, g.dtype, w.shape, g.shape)
    assert np.array_equal(w, g), what


def _same_scenario(want, got, what):
    for k in TOPO_FIELDS:
        _equal(getattr(want[0], k), getattr(got[0], k), (what, k))
    assert (want[0].fb_delay, want[0].ring_len) == (got[0].fb_delay, got[0].ring_len)
    for k in SCHED_FIELDS:
        _equal(getattr(want[1], k), getattr(got[1], k), (what, k))


def _keys(draws, seed=0):
    with jax.threefry_partitionable(False):
        keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), draws))
    return keys, convert.prng_key(keys)


# --- host: schedules, step tables, scenario rows ---------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_compile_job_equals_reference_for_every_arch(arch):
    for kw in (dict(), dict(workers=4, tp=8, iterations=2, rate=32, max_shard=512),
               dict(workers=3, tp=4, iterations=3, max_shard=96, include_allgather=False,
                    overlap={"allreduce": 0.0}),
               dict(workers=8, shape=SHAPES["train_4k"], rate=16, n_spines=2)):
        jkw = dict(kw, shape=JSHAPES["train_4k"]) if "shape" in kw else kw
        want, got = jjobs.compile_job(arch, **jkw), tjobs.compile_job(arch, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, kw)
        assert (got.total_steps, got.steps_per_iteration, got.ideal_comm_ticks) == (
            want.total_steps, want.steps_per_iteration, want.ideal_comm_ticks)
        for w, g in zip(jjobs.step_table(want), tjobs.step_table(got)):
            assert w.dtype == g.dtype and np.array_equal(w, g), (arch, kw)
        assert tjobs.total_packets(got) == jjobs.total_packets(want)


def test_scheduled_events_and_step_inputs_equal_reference():
    jscens, tscens = _library(jscen, horizon=300), _library(tscen, horizon=300)
    jj, tj = _jobs(jjobs, iterations=2), _jobs(tjobs, iterations=2)
    offsets = np.array([[0, 5, 290, 1000], [7, 3, 2, 299]], np.int64)
    for name in ("uncontended", "pfc_storm", "correlated/burst_flaps"):
        for horizon in (1, 64, 400):
            want = jjobs.scheduled_events(jscens[name][1], offsets, horizon)
            got = tjobs.scheduled_events(tscens[name][1], offsets, horizon)
            for k in SCHED_FIELDS:
                _equal(getattr(want, k), getattr(got, k), (name, horizon, k))
        want_s, want_n = jjobs.job_step_inputs(jj, jscens[name][1], 128)
        got_s, got_n = tjobs.job_step_inputs(tj, tscens[name][1], 128, device="cpu")
        _equal(want_n, got_n, name)
        for k in SCHED_FIELDS:
            _equal(getattr(want_s, k), getattr(got_s, k), (name, k))
    with pytest.raises(ValueError, match="share workers"):
        tjobs.job_step_inputs([tj[0], tjobs.compile_job("qwen3-8b", workers=3)],
                              tscens["uncontended"][1], 16)


@pytest.mark.parametrize("kw", [dict(horizon=512),
                                dict(workers=5, n_spines=3, horizon=200, bg_seed=2,
                                     flap_period=32, storm_start=8, oversub_ratio=4.0)],
                         ids=["default", "odd"])
def test_job_scenarios_equal_reference(kw):
    assert tscen.JOB_SCENARIO_NAMES == jscen.JOB_SCENARIO_NAMES
    want, got = jscen.job_scenarios(**kw), tscen.job_scenarios(**kw)
    assert tuple(got) == tscen.JOB_SCENARIO_NAMES
    for name in want:
        _same_scenario(want[name], got[name], name)


def test_job_ettr_equals_reference():
    job = _jobs(jjobs, iterations=3)[1]
    tjob = _jobs(tjobs, iterations=3)[1]
    cct = np.random.default_rng(0).integers(1, 400, (3, 2, job.total_steps)).astype(np.float32)
    for w, g in zip(jjobs.job_ettr(job, cct), tjobs.job_ettr(tjob, torch.as_tensor(cct))):
        assert g.dtype == np.float64 and np.array_equal(w, g)


# --- runs --------------------------------------------------------------------

@pytest.fixture(scope="module")
def library_runs():
    """The stacked job library x 2 models x ECMP / WAM x one draw through
    `sweep_job_steps_scenarios`, in both packages."""
    jall, tall = _library(jscen), _library(tscen)
    jscens, tscens = _stacked(jall), _stacked(tall)
    jj, tj = _jobs(jjobs), _jobs(tjobs)
    keys_np, keys = _keys(1, seed=3)
    with jax.threefry_partitionable(False):
        inputs = [jjobs.job_step_inputs(jj, s, HORIZON) for _, s in jscens.values()]
        want = jjobs.sweep_job_steps_scenarios(
            jscen.stack_pytrees([t for t, _ in jscens.values()]),
            jscen.stack_pytrees([s for s, _ in inputs]), _spec(jsender, POLICIES),
            jsender.policy_sweep_params([jsender.Policy[p] for p in POLICIES], rate=RATE),
            inputs[0][1], keys_np, HORIZON)
    want = tuple(np.asarray(x) for x in want)
    tinputs = [tjobs.job_step_inputs(tj, s, HORIZON, device="cpu") for _, s in tscens.values()]
    runs = {}
    got = tjobs.sweep_job_steps_scenarios(
        tscen.stack_pytrees([t for t, _ in tscens.values()]),
        tscen.stack_pytrees([s for s, _ in tinputs]), _spec(tsender, POLICIES),
        tsender.policy_sweep_params([tsender.Policy[p] for p in POLICIES], rate=RATE),
        tinputs[0][1], keys, HORIZON, device="cpu",
        on_run=lambda idx, out: runs.__setitem__(idx, out))
    return dict(want=want, got=got, names=list(jscens), jobs=(jj, tj), runs=runs,
                keys=(keys_np, keys), jscens=jall, tscens=tall)


def test_sweep_job_steps_scenarios_equals_reference(library_runs):
    want, got = library_runs["want"], library_runs["got"]
    C = len(library_runs["names"])
    S = library_runs["jobs"][1][0].total_steps
    assert tuple(got[0].shape) == (C, len(POLICIES), 1, len(ARCHS), S)
    _equal(want[0], got[0], "cct")
    _equal(want[1], got[1], "finished")
    assert bool(got[1].all()), "every step of the library settles within the horizon"
    assert bool((got[0][:, 1] < got[0][:, 0]).any()), "WAM beats ECMP somewhere"
    # ETTR and exposed ticks per (scenario, policy, draw, model), exact
    jj, tj = library_runs["jobs"]
    for m in range(len(ARCHS)):
        for w, g in zip(jjobs.job_ettr(jj[m], want[0][..., m, :]),
                        tjobs.job_ettr(tj[m], got[0][..., m, :])):
            assert np.array_equal(w, g)
    # every (scenario, policy, draw, model, step) was reported once
    assert len(library_runs["runs"]) == got[0].numel()


def test_size_vector_with_zeros_equals_reference(library_runs):
    """`run_flows_sized` with a [F] size vector holding zeros: the zero
    flows complete at tick 0 and emit nothing; an all-zero vector is
    settled before its first exit chunk, so it runs no tick and its link
    counters stay zero."""
    topo_j, sched_j = library_runs["jscens"]["link_flap"]
    topo_t, sched_t = library_runs["tscens"]["link_flap"]
    keys_np, keys = library_runs["keys"]
    spec_j, spec_t = _spec(jsender, ("WAM",)), _spec(tsender, ("WAM",))
    sp_j = jsender.sender_params(jsender.Policy.WAM, rate=RATE)
    sp_t = tsender.sender_params(tsender.Policy.WAM, rate=RATE)
    for sizes in ([48, 0, 17, 0], [0, 0, 0, 0]):
        with jax.threefry_partitionable(False):
            want = jax.jit(jsender.run_flows_sized, static_argnames=("spec", "horizon"))(
                topo_j, sched_j, spec_j, sp_j, np.asarray(sizes, np.int32), keys_np[0],
                horizon=HORIZON)
        got = tsender.run_flows_sized(topo_t, sched_t, spec_t, sp_t,
                                      torch.tensor(sizes, dtype=torch.int32), keys[0],
                                      HORIZON, device="cpu")
        for f in dataclasses.fields(want):
            if f.name != "ticks_run":
                _equal(getattr(want, f.name), getattr(got, f.name), (sizes, f.name))
        zero = torch.tensor(sizes) == 0
        assert bool((got.cct[zero] == 0).all()) and bool((got.sent_total[zero] == 0).all())
    assert int(got.ticks_run) == 0 and bool(got.finished.all())
    assert not bool(got.link_served.any())
    assert not bool(got.link_busy.any())


def test_sweep_job_equals_reference(library_runs):
    """`sweep_job` on the correlated library's spine outage: four policies
    (two of them stateful), two draws, one model; raw fields bit-equal,
    ETTR exact."""
    jj, tj = (j[1:] for j in library_runs["jobs"])
    keys_np, keys = _keys(2, seed=11)
    topo_j, sched_j = library_runs["jscens"]["correlated/srlg_spine_down"]
    topo_t, sched_t = library_runs["tscens"]["correlated/srlg_spine_down"]
    with jax.threefry_partitionable(False):
        want = jjobs.sweep_job(
            topo_j, sched_j, _spec(jsender, SWEEP_POLICIES),
            jsender.policy_sweep_params([jsender.Policy[p] for p in SWEEP_POLICIES],
                                        rate=RATE), jj, keys_np, HORIZON)
    got = tjobs.sweep_job(
        topo_t, sched_t, _spec(tsender, SWEEP_POLICIES),
        tsender.policy_sweep_params([tsender.Policy[p] for p in SWEEP_POLICIES], rate=RATE),
        tj, keys, HORIZON, device="cpu")
    assert set(got) == set(want) == {"cct", "finished", "ettr", "exposed"}
    for k in want:
        _equal(want[k], got[k], k)
    assert got["cct"].shape == (len(SWEEP_POLICIES), 2, 1, tj[0].total_steps)
    # flow-sharded over two ranks: WAM's first draw, equal to its slice
    sharded = tjobs.sweep_job(topo_t, sched_t, _spec(tsender, SWEEP_POLICIES),
                              tsender.policy_sweep_params([tsender.Policy.WAM], rate=RATE), tj,
                              keys[:1], HORIZON, mesh=tsender.flow_mesh(2, device="cpu"))
    wam = SWEEP_POLICIES.index("WAM")
    for k in want:
        _equal(want[k][wam:wam + 1, :1], sharded[k], ("mesh", k))


def test_run_job_with_telemetry_equals_reference(library_runs):
    """One job run (WAM on the PFC storm, two iterations) with telemetry:
    the `JobResult` fields equal and every frame leaf, stacked on the step
    axis, equal; the run without telemetry gives the same result."""
    jjob = jjobs.compile_job("qwen3-8b", workers=WORKERS, tp=8, iterations=2, rate=RATE,
                             max_shard=MAX_SHARD)
    tjob = tjobs.compile_job("qwen3-8b", workers=WORKERS, tp=8, iterations=2, rate=RATE,
                             max_shard=MAX_SHARD)
    tel = dict(stride=4, window=32)
    topo_j, sched_j = library_runs["jscens"]["pfc_storm"]
    topo_t, sched_t = library_runs["tscens"]["pfc_storm"]
    keys_np, keys = library_runs["keys"]
    with jax.threefry_partitionable(False):
        want, want_f = jjobs.run_job(
            topo_j, sched_j, _spec(jsender, ("WAM",), jtel.TelemetrySpec(**tel)),
            jsender.sender_params(jsender.Policy.WAM, rate=RATE), jjob, keys_np[0], HORIZON)
    got, got_f = tjobs.run_job(
        topo_t, sched_t, _spec(tsender, ("WAM",), ttel.TelemetrySpec(**tel)),
        tsender.sender_params(tsender.Policy.WAM, rate=RATE), tjob, keys[0], HORIZON,
        device="cpu")
    for k in ("step_cct", "ettr", "exposed_comm_ticks", "finished"):
        _equal(getattr(want, k), getattr(got, k), k)
    assert dataclasses.asdict(got.job) == dataclasses.asdict(want.job)
    want_f = convert.telemetry_frame({f.name: np.asarray(getattr(want_f, f.name))
                                      for f in dataclasses.fields(want_f)})
    for f in dataclasses.fields(got_f):
        w, g = getattr(want_f, f.name), getattr(got_f, f.name)
        assert w.dtype == g.dtype and w.shape == g.shape and torch.equal(w, g), f.name
    assert got_f.count.shape[0] == tjob.total_steps
    bare = tjobs.run_job(topo_t, sched_t, _spec(tsender, ("WAM",)),
                         tsender.sender_params(tsender.Policy.WAM, rate=RATE), tjob, keys[0],
                         HORIZON, device="cpu")
    for k in ("step_cct", "ettr", "exposed_comm_ticks", "finished"):
        assert np.array_equal(getattr(bare, k), getattr(got, k)), k


def test_run_job_rejects_a_topology_of_other_width(library_runs):
    topo_t, sched_t = library_runs["tscens"]["uncontended"]
    job = tjobs.compile_job("qwen3-8b", workers=3, max_shard=MAX_SHARD)
    with pytest.raises(ValueError, match="flows"):
        tjobs.run_job(topo_t, sched_t, _spec(tsender, ("WAM",)),
                      tsender.sender_params(tsender.Policy.WAM), job,
                      library_runs["keys"][1][0], 16, device="cpu")
