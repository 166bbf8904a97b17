"""The port's examples over `repro_torch.core` and `repro_torch.net`
(`examples/torch_quickstart.py`, `torch_telemetry_quickstart.py`,
`torch_topology_scenarios_demo.py`, `torch_collective_cct_demo.py`)
against the reference library's same calls, on the CPU.

Each example's ``main(["--device", "cpu"], **SMOKE)`` runs at the sizes
its module names (`SMOKE`, which chip_smoke.py runs too), and its
returned numbers must equal those the JAX package gives for the calls the
reference example makes at those sizes (every reference call jitted,
inside ``jax.threefry_partitionable(False)``).  The engine is bit-equal
to the reference, so every number is compared exactly: cct percentiles,
recovery statistics, ETTR (host numpy on equal inputs), profiles; and the
telemetry example's JSONL and Perfetto files byte for byte.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_zoo_reference import one_torch_thread  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro import net as jnet  # noqa: E402
from repro.net import scenarios as jscen  # noqa: E402
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


def test_quickstart_matches_reference():
    ex = example("quickstart")
    got = ex.main(CPU, **ex.SMOKE)
    packets = ex.SMOKE["packets"]
    profile = jcore.quantize_profile(np.array(ex.SHARES), ell=ex.ELL)
    state = jcore.make_spray_state(profile, method=jcore.SprayMethod.SHUFFLE_1, sa=ex.SA,
                                   sb=ex.SB)
    paths, _, _ = jax.jit(lambda: jcore.spray_batch(state, profile, packets))()
    b = np.asarray(profile.b)
    counts = np.bincount(np.asarray(paths), minlength=len(ex.SHARES))
    assert got["b"] == b.tolist() and got["counts"] == counts.tolist()
    assert got["drift"] == int(np.abs(counts - b * packets // (1 << ex.ELL)).max())
    assert got["deviations"] == jcore.path_deviations(
        profile, jcore.SprayMethod.SHUFFLE_1, ex.SA, ex.SB).tolist()

    step = jax.jit(jcore.controller_step)
    ctrl = jcore.make_controller(profile)
    bad = jcore.PathStats(ecn_rate=jnp.asarray([0.0, 0.7, 0.0, 0.0, 0.0]),
                          loss_rate=jnp.asarray([0.0, 0.2, 0.0, 0.0, 0.0]),
                          rtt=jnp.asarray([10.0, 45.0, 10.0, 11.0, 10.0]))
    whacked = []
    for _ in range(ex.WHACKS):
        ctrl, w = step(ctrl, bad)
        whacked.append(np.asarray(ctrl.profile.b).tolist())
    assert got["whacked"] == whacked
    healthy = jcore.PathStats(ecn_rate=jnp.zeros(5), loss_rate=jnp.zeros(5),
                              rtt=jnp.full(5, 10.0))
    healing = []
    for tick in range(ex.HEAL_TICKS):
        ctrl, w = step(ctrl, healthy)
        if tick % 6 == 5:
            healing.append((np.asarray(ctrl.profile.b).tolist(), float(w[1])))
    assert got["healing"] == healing
    assert got["recovered"] == np.asarray(ctrl.profile.b).tolist()


def test_telemetry_quickstart_matches_reference(tmp_path):
    ex = example("telemetry_quickstart")
    got = ex.main(CPU, **ex.SMOKE, out_dir=str(tmp_path / "port"))
    horizon, n_packets = ex.SMOKE["horizon"], ex.SMOKE["n_packets"]
    policies = tuple(Policy[p.name] for p in ex.POLICIES)
    with jax.threefry_partitionable(False):
        topo, sched = jscen.link_flap(flows=8, n_spines=4, period=64, horizon=horizon)
        spec = jnet.SenderSpec(rate_cap=32, early_exit=True,
                               telemetry=jnet.TelemetrySpec(stride=2, window=horizon // 2))
        sp = jnet.policy_sweep_params(policies, rate=32)
        keys = jax.random.split(jax.random.PRNGKey(0), 1)
        _, frame = jnet.sweep_flows(topo, sched, spec, sp, n_packets, keys, horizon=horizon)
    onsets = jnet.event_onsets(sched)
    tol = (1 << spec.ell) / 32
    ref_dir = tmp_path / "reference"
    ref_dir.mkdir()
    for pi, pol in enumerate(policies):
        ser = jnet.series(jnet.frame_select(frame, (pi, 0)))
        rec = jnet.summarize_recovery(jnet.recovery_ticks(ser["tick"], ser["alloc"], onsets,
                                                          tol=tol))
        qp = jnet.queue_percentiles(ser)
        assert got[pol.name] == dict(
            samples=len(ser["tick"]), events=rec["events"], recovered=rec["recovered_frac"],
            p50=rec["p50"], max=rec["max"], disc_max=float(np.max(ser["disc"])),
            q_hot_p99=qp["hot_p99"])
        stem = f"flap_{pol.name}"
        jnet.write_series_jsonl(str(ref_dir / f"{stem}.jsonl"), ser, meta={
            "name": f"demo/flap/{pol.name}", "policy": pol.name, "onsets": onsets.tolist(),
            "tol": tol})
        (ref_dir / f"{stem}.trace.json").write_text(
            json.dumps(jnet.chrome_trace(ser, onsets=onsets, max_links=4)))
        for suffix in (".jsonl", ".trace.json"):
            assert ((tmp_path / "port" / f"{stem}{suffix}").read_bytes()
                    == (ref_dir / f"{stem}{suffix}").read_bytes()), stem + suffix


def test_topology_scenarios_demo_matches_reference():
    ex = example("topology_scenarios_demo")
    s = ex.SMOKE
    got = ex.main(CPU, **s)
    policies = tuple(Policy[p.name] for p in ex.POLICIES)
    with jax.threefry_partitionable(False):
        keys = jax.random.split(jax.random.PRNGKey(0), s["draws"])
        spec = jnet.SenderSpec(rate_cap=32)
        sp = jnet.policy_sweep_params(policies, rate=32)
        for name in s["scenarios"]:
            topo, sched = jscen.SCENARIOS[name]()
            cct = np.asarray(jnet.sweep_flows(topo, sched, spec, sp, s["n_packets"], keys,
                                              horizon=s["horizon"]).cct)
            for pi, pol in enumerate(policies):
                flat = cct[pi].reshape(-1)
                assert got["scenarios"][name][pol.name] == (
                    float(np.percentile(flat, 50)), float(np.percentile(flat, 99))), name
        topo, sched = jscen.straggler_worker(workers=4, n_spines=4, factor=0.25)
        ccfg = jnet.CollectiveConfig(workers=4, shard_packets=s["shard_packets"],
                                     horizon=s["horizon"])
        for pol in policies:
            total, per_step, finished = jnet.allreduce_cct_shared(
                topo, sched, jnet.TransportConfig(policy=pol, rate=32), ccfg,
                jax.random.PRNGKey(1))
            assert got["straggler"][pol.name] == (float(total), float(per_step.max()),
                                                   bool(finished.all()))


def test_collective_cct_demo_matches_reference():
    ex = example("collective_cct_demo")
    s = ex.SMOKE
    got = ex.main(CPU, **s)
    params = jnet.FabricParams(
        capacity=jnp.full((8,), 8.0), latency=jnp.full((8,), 4, jnp.int32),
        queue_limit=jnp.full((8,), 48.0), ecn_threshold=jnp.full((8,), 12.0),
        degrade_p=jnp.full((8,), 0.003), recover_p=jnp.full((8,), 0.005),
        degrade_factor=jnp.full((8,), 0.05), fb_delay=8, ring_len=128)
    ccfg = jnet.CollectiveConfig(workers=4, shard_packets=s["shard_packets"],
                                 horizon=s["horizon"])
    ideal = 6 * jnet.ideal_step_ticks(params, s["shard_packets"], 48)
    assert got["ideal"] == ideal
    with jax.threefry_partitionable(False):
        for pol in s["policies"]:
            for coded in (False, True):
                tcfg = jnet.TransportConfig(policy=Policy[pol.name], coded=coded, rate=48)
                totals = [float(jnet.allreduce_cct(params, tcfg, ccfg,
                                                   jax.random.PRNGKey(k))[0])
                          for k in range(s["seeds"])]
                e = jnet.ettr(ex.COMPUTE_TICKS, np.asarray(totals), ideal)
                assert got["rows"][f"{pol.name}/{'coded' if coded else 'arq'}"] == (
                    float(np.mean(totals)), float(e))
