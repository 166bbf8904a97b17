"""`chip_smoke.py` pins the JAX package's cct digests of the full-width job
and cluster cells, and the card's runs must reproduce them.  These tests
recompute both digests with the reference on the CPU (jitted, inside
``jax.threefry_partitionable(False)``) from the script's own settings, so
a pin cannot drift from what the reference computes."""
import hashlib
import importlib.util
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")
import jax  # noqa: E402

from repro.net import cluster as jcl  # noqa: E402
from repro.net import jobs as jjobs  # noqa: E402
from repro.net import scenarios as jscen  # noqa: E402
from repro.net import sender as jsender  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(cct) -> str:
    """`chip_smoke._digest` on a reference array."""
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(cct).astype(np.float32)).tobytes()).hexdigest()[:16]


def _sweep(smoke):
    spec = jsender.SenderSpec(rate_cap=smoke.JOB_RATE, early_exit=True,
                              exit_chunk=smoke.JOB_EXIT_CHUNK)
    sp = jsender.policy_sweep_params([jsender.Policy[p] for p in smoke.JOB_POLICIES],
                                     rate=smoke.JOB_RATE)
    return spec, sp, jax.random.split(jax.random.PRNGKey(0), 2)[:1]


def test_job_cell_digest_is_the_reference(smoke):
    with jax.threefry_partitionable(False):
        spec, sp, keys = _sweep(smoke)
        job = jjobs.compile_job(smoke.JOB_ARCH, workers=smoke.JOB_WORKERS, tp=smoke.JOB_TP,
                                iterations=smoke.JOB_ITERATIONS, rate=smoke.JOB_RATE,
                                max_shard=smoke.JOB_MAX_SHARD)
        lib = jscen.job_scenarios(workers=smoke.JOB_WORKERS, horizon=smoke.JOB_HORIZON)
        inputs = [jjobs.job_step_inputs([job], s, smoke.JOB_HORIZON) for _, s in lib.values()]
        cct, fin = jjobs.sweep_job_steps_scenarios(
            jscen.stack_pytrees([t for t, _ in lib.values()]),
            jscen.stack_pytrees([s for s, _ in inputs]), spec, sp, inputs[0][1], keys,
            smoke.JOB_HORIZON)
    assert np.asarray(cct).shape == (6, len(smoke.JOB_POLICIES), 1, 1, job.total_steps)
    assert bool(np.all(fin))
    assert _digest(cct) == smoke.JOB_DIGEST


def test_cluster_cell_digest_is_the_reference(smoke):
    with jax.threefry_partitionable(False):
        spec, sp, keys = _sweep(smoke)
        js = [jjobs.compile_job(a, workers=smoke.JOB_WORKERS, tp=smoke.JOB_TP,
                                iterations=smoke.JOB_ITERATIONS, rate=smoke.JOB_RATE,
                                max_shard=smoke.CLUSTER_MAX_SHARD) for a in smoke.CLUSTER_ARCHS]
        lib = jscen.cluster_scenarios(js, horizon=smoke.JOB_HORIZON)
        raw = []
        for name in smoke.CLUSTER_SCENARIOS:
            placed, topo, sched = lib[name]
            scheds, sizes = jcl.cluster_inputs(placed, sched, smoke.CLUSTER_HORIZON)
            out = jcl.sweep_cluster_rounds(topo, scheds, spec, sp, sizes, keys,
                                           smoke.CLUSTER_HORIZON)
            assert bool(np.all(out["finished"]))
            raw.append(np.asarray(out["cct"]))
    assert _digest(np.stack(raw)) == smoke.CLUSTER_DIGEST
