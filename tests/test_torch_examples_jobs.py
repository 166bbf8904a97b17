"""The port's job and cluster examples (`examples/torch_job_ettr_quickstart.py`,
`torch_cluster_contention_demo.py`) against the reference library's same
calls, on the CPU.

Each example's ``main(["--device", "cpu"], **SMOKE)`` runs at the sizes
its module names (`SMOKE`, which chip_smoke.py runs too); the reference's
`compile_job`, `run_job` and `run_cluster` run the calls the reference
examples make at those sizes, inside ``jax.threefry_partitionable(False)``.
Schedules, ETTR, slowdowns and Jain's index are the reference's host
numpy over bit-equal cct values, so they are compared exactly.
"""
import importlib.util
import pathlib

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_zoo_reference import one_torch_thread  # noqa: E402
from repro.net import cluster as jcluster  # noqa: E402
from repro.net import jobs as jjobs  # noqa: E402
from repro.net import scenarios as jscen  # noqa: E402
from repro.net import sender as jsender  # noqa: E402
from repro.net.transport import Policy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread a worker (`one_torch_thread`)."""
    with one_torch_thread():
        yield


def example(name):
    spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                  ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_job_ettr_quickstart_matches_reference():
    ex = example("job_ettr_quickstart")
    s = ex.SMOKE
    got = ex.main(CPU, **s)
    job = jjobs.compile_job(ex.ARCH, workers=ex.WORKERS, tp=8, iterations=1, rate=ex.RATE,
                            max_shard=s["max_shard"])
    assert got["compute_ticks"] == job.compute_ticks
    assert got["ratio"] == job.compute_comm_ratio
    assert got["phases"] == [(ph.kind, ph.ring_steps, ph.shard_packets, ph.overlap_ticks)
                             for ph in job.phases]
    scens = jscen.job_scenarios(workers=ex.WORKERS, horizon=2048)
    spec = jsender.SenderSpec(rate_cap=ex.RATE)
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(0)
        for name in s["scenarios"]:
            topo, sched = scens[name]
            for pol in (Policy.ECMP, Policy.WAM):
                r = jjobs.run_job(topo, sched, spec, jsender.sender_params(pol, rate=ex.RATE),
                                  job, key, horizon=s["horizon"])
                assert got["ettr"][name][pol.name] == float(r.ettr), (name, pol.name)


def test_cluster_contention_demo_matches_reference():
    ex = example("cluster_contention_demo")
    s = ex.SMOKE
    got = ex.main(CPU, **s)
    jobs = [jjobs.compile_job(arch, workers=ex.WORKERS, tp=8, iterations=1, rate=ex.RATE,
                              max_shard=s["max_shard"]) for arch in ex.ARCHS]
    assert got["jobs"] == [(job.total_steps, job.compute_comm_ratio) for job in jobs]
    scens = jscen.cluster_scenarios(jobs, horizon=2048)
    spec = jsender.SenderSpec(rate_cap=ex.RATE)
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(0)
        for name in s["scenarios"]:
            cluster, topo, sched = scens[name]
            for pol in (Policy[p.name] for p in s["policies"]):
                r = jcluster.run_cluster(topo, sched, spec,
                                         jsender.sender_params(pol, rate=ex.RATE), cluster,
                                         key, horizon=s["horizon"])
                assert got["rows"][f"{name}/{pol.name}"] == (
                    [float(r.ettr[j]) for j in range(2)],
                    [float(r.slowdown[j]) for j in range(2)], float(r.jain)), (name, pol.name)
