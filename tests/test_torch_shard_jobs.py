"""The port's flow-sharded job and cluster runners and the CLIs'
``--devices`` on the CPU, against the JAX package's unsharded runners.

Ranks are threads with private gloo groups (``flow_mesh(n,
device="cpu")``).  `sweep_job` with a mesh of two ranks over a ring of
three workers (padded to four flows) on the link-flap scenario, ECMP and
WAM: raw fields and ETTR equal to the reference's `sweep_job`;
`shard_run_job_steps` at three ranks equal to its WAM slice's first
steps.
Two two-worker jobs placed one leaf a pod on a fat-tree (their rings
cross the core): `shard_sweep_cluster_rounds` over two ranks equal to the
reference's raw `sweep_cluster_rounds`, `sweep_cluster` with a mesh of two
ranks equal to every metric of its WAM slice, `shard_run_cluster_rounds`
at three ranks to its first round.  Then ``jobsim`` and ``clustersim``
with ``--devices 2 --device cpu`` print what the unsharded runs print.
Reference calls run inside ``jax.threefry_partitionable(False)``, once per
module."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.net import cluster as jcl  # noqa: E402
from repro.net import jobs as jjobs  # noqa: E402
from repro.net import scenarios as jscen  # noqa: E402
from repro.net import sender as jsender  # noqa: E402
from repro.net import topology as jtop  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import clustersim, jobsim  # noqa: E402
from repro_torch.net import cluster as tcl  # noqa: E402
from repro_torch.net import jobs as tjobs  # noqa: E402
from repro_torch.net import scenarios as tscen  # noqa: E402
from repro_torch.net import sender as tsender  # noqa: E402
from repro_torch.net import telemetry as ttel  # noqa: E402
from repro_torch.net import topology as ttop  # noqa: E402

RATE, HORIZON = 16, 512
POLICIES = ("ECMP", "WAM")
METRICS = ("ettr", "solo_ettr", "slowdown", "jain", "link_util", "finished")
RAW = ("cct", "finished", "link_served", "link_busy")


def _job(mod, workers):
    return mod.compile_job("xlstm-350m", workers=workers, tp=8, iterations=1, rate=RATE,
                           min_shard=16, max_shard=48,
                           overlap={"allreduce": 0.0, "allgather": 0.0})


def _spec(mod):
    return mod.SenderSpec(rate_cap=RATE, early_exit=True, exit_chunk=8)


def _sp(mod):
    return mod.policy_sweep_params([mod.Policy[p] for p in POLICIES], rate=RATE)


def _keys(seed):
    with jax.threefry_partitionable(False):
        keys = jax.random.split(jax.random.PRNGKey(seed), 1)
    return keys, convert.prng_key(np.asarray(keys))


def _mesh(n):
    return tsender.flow_mesh(n, device="cpu", timeout=60)


def _equal(want, got, what):
    w, g = np.asarray(want), got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert w.dtype == g.dtype and w.shape == g.shape, (what, w.dtype, g.dtype, w.shape, g.shape)
    assert np.array_equal(w, g), what


@pytest.fixture(scope="module")
def job_runs():
    """`sweep_job` on link_flap, a ring of three workers: the reference's
    and the port's over a mesh of two ranks."""
    jkeys, tkeys = _keys(7)
    jtopo, jsched = jscen.job_scenarios(workers=3, horizon=HORIZON)["link_flap"]
    with jax.threefry_partitionable(False):
        want = jjobs.sweep_job(jtopo, jsched, _spec(jsender), _sp(jsender), [_job(jjobs, 3)],
                               jkeys, HORIZON)
    topo, sched = tscen.job_scenarios(workers=3, horizon=HORIZON)["link_flap"]
    job = _job(tjobs, 3)
    got = tjobs.sweep_job(topo, sched, _spec(tsender), _sp(tsender), [job], tkeys, HORIZON,
                          mesh=_mesh(2))
    return dict(want=want, got=got, topo=topo, sched=sched, job=job, keys=tkeys)


@pytest.fixture(scope="module")
def cluster_runs():
    """Two two-worker jobs, one leaf a pod on a fat-tree: the reference's
    raw `sweep_cluster_rounds` and the port's `shard_sweep_cluster_rounds`
    over a mesh of two ranks."""
    jkeys, tkeys = _keys(8)
    out = {}
    for name, mod, top in (("ref", jcl, jtop), ("port", tcl, ttop)):
        cl = mod.place_jobs_pods([_job(jjobs if mod is jcl else tjobs, 2)] * 2,
                                 leaves_per_pod=1)
        topo = mod.cluster_fat_tree_topology(cl, leaves_per_pod=1)
        sched = top.null_schedule(topo.links)
        out[name] = (cl, topo, sched) + tuple(mod.cluster_inputs(cl, sched, HORIZON))
    cl, topo, _, scheds, sizes = out["ref"]
    with jax.threefry_partitionable(False):
        want = jcl.sweep_cluster_rounds(topo, scheds, _spec(jsender), _sp(jsender), sizes,
                                        jkeys, HORIZON)
    cl, topo, _, scheds, sizes = out["port"]
    got = tcl.shard_sweep_cluster_rounds(topo, scheds, _spec(tsender), _sp(tsender), sizes,
                                         tkeys, HORIZON, mesh=_mesh(2))
    return dict(want=want, got=got, ref=out["ref"], port=out["port"], keys=tkeys)


def test_sweep_job_mesh_equals_reference(job_runs):
    want, got = job_runs["want"], job_runs["got"]
    assert set(got) == set(want) == {"cct", "finished", "ettr", "exposed"}
    for k in want:
        _equal(want[k], got[k], k)
    assert got["cct"].shape == (len(POLICIES), 1, 1, job_runs["job"].total_steps)


def test_shard_run_job_steps_three_ranks_equals_the_slice(job_runs):
    """Three ranks over three workers (no padding) and the raw steps of
    WAM's draw: the reference sweep's slice."""
    scheds, shard = tjobs.job_step_inputs([job_runs["job"]], job_runs["sched"], HORIZON)
    sp = tsender.sender_params(tsender.Policy.WAM, rate=RATE)
    steps = 2  # a prefix of the schedule: step s runs fold_in(key, s)
    cct, fin = tjobs.shard_run_job_steps(job_runs["topo"],
                                         ttel.frame_select(scheds, (0, slice(0, steps))),
                                         _spec(tsender), sp, shard[0, :steps],
                                         job_runs["keys"][0], HORIZON, mesh=_mesh(3))
    _equal(job_runs["want"]["cct"][1, 0, 0, :steps], cct, "cct")
    _equal(job_runs["want"]["finished"][1, 0, 0, :steps], fin, "finished")


def test_shard_sweep_cluster_rounds_equals_reference(cluster_runs):
    """Two ranks: every raw field of ``[P, D, V, R, F]`` equal."""
    for k in RAW:
        _equal(cluster_runs["want"][k], cluster_runs["got"][k], k)


def test_sweep_cluster_mesh_equals_reference(cluster_runs):
    """`sweep_cluster` over two ranks, WAM: every metric equal to the
    reference's WAM slice, its rings through the core tier."""
    cl, topo, sched = cluster_runs["port"][:3]
    got = tcl.sweep_cluster(topo, sched, _spec(tsender),
                            tsender.policy_sweep_params([tsender.Policy.WAM], rate=RATE), cl,
                            cluster_runs["keys"], HORIZON, mesh=_mesh(2))
    wam = {k: np.asarray(v)[1:] for k, v in cluster_runs["want"].items()}
    want = jcl.cluster_metrics(*cluster_runs["ref"][:2], wam)
    for k in METRICS:
        _equal(getattr(want, k), getattr(got, k), k)
    for j, (w, g) in enumerate(zip(want.step_cct, got.step_cct)):
        _equal(w, g, ("step_cct", j))
    assert bool(np.all(got.finished))
    grid = ttop.FatTreeGrid(n_pods=4, leaves_per_pod=1, spines_per_pod=2, cores_per_spine=2)
    assert got.link_util[..., grid.tier_slices()["spine_core_up"]].max() > 0


def test_shard_run_cluster_rounds_three_ranks_equals_the_slice(cluster_runs):
    """`shard_run_cluster_rounds` at three ranks (four flows padded to six)
    over the first round, every size variant, WAM's draw: the reference
    sweep's slice (round r runs ``fold_in(key, r)``)."""
    topo, scheds, sizes = (cluster_runs["port"][i] for i in (1, 3, 4))
    one = tcl.shard_run_cluster_rounds(topo, ttel.frame_select(scheds, slice(0, 1)),
                                       _spec(tsender),
                                       tsender.sender_params(tsender.Policy.WAM, rate=RATE),
                                       sizes[:, :1], cluster_runs["keys"][0], HORIZON,
                                       mesh=_mesh(3))
    for k in RAW:
        _equal(np.asarray(cluster_runs["want"][k])[1, 0][:, :1], one[k], ("WAM", k))


@pytest.mark.parametrize("cli", ["jobsim", "clustersim"])
def test_cli_devices_prints_the_unsharded_numbers(cli, tmp_path, capsys):
    """``--devices 2 --device cpu``: the same lines and ``--json`` payload
    as the unsharded run, after one line that names the ranks."""
    main, args = {"jobsim": (jobsim.main, ["--arch", "xlstm-350m", "--scenario", "pfc_storm"]),
                  "clustersim": (clustersim.main, ["--archs", "xlstm-350m,qwen3-8b",
                                                   "--scenario", "rings_overlapped"])}[cli]
    common = args + ["--policies", "WAM", "--draws", "1", "--iterations", "1", "--workers",
                     "2", "--max-shard", "16", "--horizon", "16", "--device", "cpu", "--json"]
    main(common + [str(tmp_path / "one.json")])
    one = capsys.readouterr().out
    main(common + [str(tmp_path / "two.json"), "--devices", "2"])
    two = capsys.readouterr().out
    assert two.splitlines()[0] == ("devices: 2 flow ranks on cpu (flow-sharded sweep, "
                                   "bit-identical to unsharded)")
    assert two.splitlines()[1:-1] == one.splitlines()[:-1]
    assert (json.loads((tmp_path / "two.json").read_text())
            == json.loads((tmp_path / "one.json").read_text()))
