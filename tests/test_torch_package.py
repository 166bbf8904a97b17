"""Package rules of the port: no JAX and nothing of `repro` in it, entry
points that run on the card unless asked otherwise, a chip smoke test
whose golden case table is the generator's, and port tests that change no
process-wide state when they are imported."""
import ast
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "scripts").glob("*.py")))
PORT_TESTS = sorted((ROOT / "tests").glob("test_torch_*.py"))
# process-wide state a test file must not touch while it is imported: the
# module table (a stub left there leaks into every later file of the
# worker), JAX's config and torch's global defaults
GLOBAL_STATE = ("sys.modules", "jax.config", "torch.set_default", "torch.set_float32_matmul",
                "torch.use_deterministic", "torch.backends", "torch.manual_seed",
                "torch.set_grad_enabled", "np.random.seed", "numpy.random.seed")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def test_port_checks_cover_the_training_modules():
    """The import rule above walks every module of the port, the training
    slice's among them."""
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES
             if (ROOT / "src" / "repro_torch") in p.parents}
    assert {"tree.py", "optim/adamw.py", "optim/adafactor.py", "optim/api.py", "train/state.py",
            "train/step.py", "data/pipeline.py", "ckpt/checkpoint.py",
            "launch/train.py"} <= names


def test_reference_stubs_leave_nothing_behind():
    """The reference zoo's stubs (`_torch_zoo_reference.reference_zoo`)
    import the JAX trainer and leave no `repro.dist*`, `repro.models*`,
    `repro.train*` or `repro.launch.train` module behind, so that
    `test_train.py`'s ``importorskip("repro.dist")`` still skips."""
    import importlib
    import sys

    from _torch_zoo_reference import reference_zoo

    def stubbed():
        return [n for n in sys.modules if n.split(".")[:2] in (["repro", "dist"],
                                                               ["repro", "train"])
                or n.startswith("repro.launch.train")]

    assert not stubbed()
    with reference_zoo():
        step = importlib.import_module("repro.train.step")
        with pytest.raises(RuntimeError, match="stub"):
            step.sprayed_psum(None, "data")
        assert "repro.dist.sprayed_collectives" in sys.modules
    assert not stubbed()
    with pytest.raises(ImportError):
        importlib.import_module("repro.dist")


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        return ".".join([node.id, *reversed(parts)])
    return None


def _import_time_nodes(tree):
    """Every node that runs when the module is imported: module and class
    bodies, decorators and default values, but no function body."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(node.decorator_list)
            stack.extend(node.args.defaults)
            stack.extend(d for d in node.args.kw_defaults if d is not None)
        elif isinstance(node, ast.Lambda):
            stack.extend(node.args.defaults)
        else:
            stack.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", PORT_TESTS, ids=lambda p: p.name)
def test_port_tests_touch_no_global_state_at_import(path):
    """A port test file that stubs a module or flips a JAX or torch setting
    at import time changes what every later test file of its worker sees."""
    for node in _import_time_nodes(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module in ("jax", "sys", "torch"):
            bad = {"config", "modules", "set_default_dtype", "set_default_device"}
            names = {a.name for a in node.names}
            assert not names & bad, f"{path.name} imports {names & bad} from {node.module}"
        name = _dotted(node) if isinstance(node, ast.Attribute) else None
        if name is not None:
            assert not name.startswith(GLOBAL_STATE), f"{path.name} touches {name} at import"


def test_chip_smoke_case_table_matches_generator():
    gen = _load("gen_golden_transport", ROOT / "tests" / "golden" / "gen_golden_transport.py")
    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    want = []
    for file, cases in (("transport_seed.npz", gen.golden_cases()),
                        ("transport_policies.npz", gen.golden_policy_cases())):
        want += [(file, name, "bundle", params, cfg, npk, seed, hz)
                 for name, params, cfg, npk, seed, hz in cases]
    topo, sched, cfg, npk, seed, hz = gen.golden_flows_case()
    want.append(("transport_seed.npz", "FLOWS/WAM", "leaf_spine", topo, cfg, npk, seed, hz))
    want += [("transport_policies.npz", name, "leaf_spine", topo, cfg, npk, seed, hz)
             for name, topo, sched, cfg, npk, seed, hz in gen.golden_policy_flows_cases()]
    got = smoke.GOLDEN_CASES
    assert sorted((w[0], w[1]) for w in want) == sorted((g["file"], g["name"]) for g in got)
    by_name = {(g["file"], g["name"]): g for g in got}
    g = smoke.GOLDEN_TOPOLOGY
    ref_topo = gen.leaf_spine(g["n_leaves"], g["n_spines"], list(g["pairs"]),
                              uplink_capacity=g["uplink_capacity"])
    for file, name, kind, params, cfg, npk, seed, hz in want:
        case = by_name[(file, name)]
        assert (case["fabric"], case["n_packets"], case["seed"], case["horizon"]) == (
            kind, npk, seed, hz), name
        port_cfg = smoke.golden_config(case["cfg"])
        for field in ("coded", "code_overhead", "rate", "ell", "ctrl_interval", "seed", "cwnd"):
            assert getattr(port_cfg, field) == getattr(cfg, field), (name, field)
        assert int(port_cfg.policy) == int(cfg.policy) and int(port_cfg.method) == int(cfg.method)
        if kind == "bundle":
            port = smoke.golden_fabric(case["n"], "cpu")
            for field in ("capacity", "latency", "queue_limit", "ecn_threshold",
                          "degrade_p", "recover_p", "degrade_factor"):
                w = np.asarray(getattr(params, field))
                assert np.array_equal(w, getattr(port, field).numpy()), (name, field)
                assert w.dtype == getattr(port, field).numpy().dtype, (name, field)
            assert (port.fb_delay, port.ring_len) == (params.fb_delay, params.ring_len)
        else:
            for field in ("route", "capacity", "queue_limit", "latency", "degrade_p"):
                assert np.array_equal(np.asarray(getattr(params, field)),
                                      np.asarray(getattr(ref_topo, field))), (name, field)


def test_entry_points_default_to_the_card():
    """Called without ``device=``, an entry point runs on the card: where
    there is none it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from repro_torch import random as prng
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data import pipeline
    from repro_torch.launch import clustersim, jobsim, serve, train
    from repro_torch.models import model
    from repro_torch.net import (cluster, collectives, fountain, jobs, scenarios, sender,
                                 topology, transport)
    from repro_torch.serve_router import Router
    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    cfg = transport.TransportConfig(policy=transport.Policy.WAM, rate=4)
    key = prng.PRNGKey(0)
    keys = key.reshape(1, 2)
    sweep = sender.policy_sweep_params((transport.Policy.WAM,), rate=4)
    topo = topology.leaf_spine(2, 2, [(0, 1)])
    sched = topology.null_schedule(topo.links)
    calls = [
        lambda: transport.simulate_message(smoke.golden_fabric(4, "cpu"), cfg, 8, key, 16),
        lambda: transport.simulate_flows(topo, sched, cfg, 8, key, 16),
        lambda: sender.run_message(smoke.golden_fabric(4, "cpu"), cfg.spec(), cfg.params(),
                                   8, key, 16),
        lambda: sender.run_flows(topo, sched, cfg.spec(), cfg.params(), 8, key, 16),
        lambda: sender.run_flows_sized(topo, sched, cfg.spec(), cfg.params(), 8, key, 16),
        lambda: sender.sweep_message(smoke.golden_fabric(4, "cpu"), cfg.spec(), sweep, 8,
                                     keys, 16),
        lambda: sender.sweep_flows(topo, sched, cfg.spec(), sweep, 8, keys, 16),
        lambda: sender.sweep_flows_scenarios(*scenarios.stack_scenarios([(topo, sched)]),
                                             cfg.spec(), sweep, 8, keys, 16),
        lambda: fountain.encode(np.zeros((4, 4), np.uint32), np.zeros((2, 1), np.int32),
                                np.ones((2, 1), bool)),
        lambda: fountain.decode_overhead_curve(16, 1, np.random.default_rng(0)),
        lambda: Router([1, 1]),
        lambda: model.make_cache(get_smoke_config("qwen3-8b"), 1, 8),
        lambda: serve.main(["--arch", "qwen3-8b", "--smoke"]),
        lambda: train.main(["--arch", "qwen3-8b", "--smoke", "--steps", "1"]),
        lambda: pipeline.host_batch(pipeline.SyntheticLM(256, 8, 2), 0),
    ]
    ring = collectives.ring_topology(4)
    job = jobs.compile_job("qwen3-8b", max_shard=16)
    jscheds, shard = jobs.job_step_inputs([job], sched, 16, device="cpu")
    placed = cluster.place_jobs([job, job])
    ctopo = cluster.cluster_topology(placed)
    cscheds, sizes = cluster.cluster_inputs(placed, sched, 16, device="cpu")
    ccfg = collectives.CollectiveConfig(workers=4, shard_packets=8, horizon=16)
    calls += [
        lambda: jobs.run_job(ring, sched, cfg.spec(), cfg.params(), job, key, 16),
        lambda: jobs.sweep_job(ring, sched, cfg.spec(), sweep, [job], keys, 16),
        lambda: jobs.run_job_steps(ring, jobs.scheduled_events(sched, jobs.step_table(job)[2],
                                                                16, device="cpu"),
                                   cfg.spec(), cfg.params(), shard[0], key, 16),
        lambda: jobs.sweep_job_steps(ring, jscheds, cfg.spec(), sweep, shard, keys, 16),
        lambda: cluster.run_cluster(ctopo, sched, cfg.spec(), cfg.params(), placed, key, 16),
        lambda: cluster.sweep_cluster(ctopo, sched, cfg.spec(), sweep, placed, keys, 16),
        lambda: cluster.run_cluster_rounds(ctopo, cscheds, cfg.spec(), cfg.params(), sizes,
                                           key, 16),
        lambda: cluster.sweep_cluster_rounds(ctopo, cscheds, cfg.spec(), sweep, sizes, keys,
                                             16),
        lambda: collectives.allreduce_cct_shared(ring, sched, cfg, ccfg, key),
        lambda: collectives.allgather_cct_shared(ring, sched, cfg, ccfg, key),
        lambda: collectives.sweep_ring_cct_shared(ring, sched, cfg.spec(), sweep, 8, keys, 16),
        lambda: collectives.allreduce_cct(smoke.golden_fabric(4, "cpu"), cfg, ccfg, key),
        lambda: jobsim.main(["--max-shard", "16", "--horizon", "16", "--iterations", "1"]),
        lambda: clustersim.main(["--max-shard", "16", "--horizon", "16"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_telemetry_not_ported_raises():
    """Telemetry is ported: a `TelemetrySpec` gives (SimResult, frame),
    and anything else in its place raises instead of being ignored."""
    from repro_torch import random as prng
    from repro_torch.net import sender, telemetry, topology
    topo = topology.leaf_spine(2, 2, [(0, 1)])
    sched = topology.null_schedule(topo.links)
    sp = sender.sender_params(4, rate=4)
    spec = sender.SenderSpec(rate_cap=4, telemetry=object())
    with pytest.raises(TypeError):
        sender.run_flows(topo, sched, spec, sp, 8, prng.PRNGKey(0), 16, device="cpu")
    spec = sender.SenderSpec(rate_cap=4, telemetry=telemetry.TelemetrySpec(stride=2, window=4))
    result, frame = sender.run_flows(topo, sched, spec, sp, 8, prng.PRNGKey(0), 16,
                                     device="cpu")
    assert isinstance(result, sender.SimResult) and isinstance(frame, telemetry.TelemetryFrame)


def test_convert_carries_reference_parameters():
    """`repro_torch.convert` turns the reference's parameters, handed over
    as numpy arrays, into the port's objects."""
    import jax
    from repro.net import sender as jsender
    from repro.net import transport as jtr
    from repro_torch import convert
    from repro_torch.net import transport as tt

    cfg = jtr.TransportConfig(policy=jtr.Policy.CC_COUPLED, coded=False, rate=12,
                              seed=(5, 7), cwnd=64.0, ctrl_interval=3)
    jp = jsender.sender_params(cfg.policy, rate=cfg.rate, cwnd=cfg.cwnd,
                               code_overhead=cfg.code_overhead,
                               ctrl_interval=cfg.ctrl_interval, seed=cfg.seed)
    arrays = {k: np.asarray(getattr(jp, k)) for k in
              ("policy", "rate", "cwnd", "code_overhead", "ctrl_interval", "sa", "sb")}
    port = tt.TransportConfig(policy=tt.Policy.CC_COUPLED, coded=False, rate=12,
                              seed=(5, 7), cwnd=64.0, ctrl_interval=3).params()
    got = convert.sender_params(arrays)
    for field in arrays:
        want = getattr(port, field)
        if isinstance(want, float):  # the reference holds float32 scalars
            assert np.float32(getattr(got, field)) == np.float32(want), field
        else:
            assert getattr(got, field) == want, field
    key = jax.random.PRNGKey(42)
    assert convert.prng_key(np.asarray(key)).tolist() == np.asarray(key).tolist()
    with pytest.raises(ValueError):
        convert.prng_key(np.zeros(3, np.uint32))


def test_job_and_cluster_clis_write_the_library_calls_payload(tmp_path, capsys):
    """`jobsim` and `clustersim` with ``--device cpu --json`` at smoke
    sizes: the payload equals the one built from the library calls the
    CLI stands for (the reference's keys, the same numbers)."""
    import json

    from repro_torch import random as prng
    from repro_torch.launch import clustersim, jobsim
    from repro_torch.net import cluster, jobs, scenarios, sender
    from repro_torch.net.transport import Policy

    policies = (Policy.WAM, Policy.ECMP)
    spec = sender.SenderSpec(rate_cap=32)
    sp = sender.stack_params([sender.sender_params(p, rate=32) for p in policies])
    keys = prng.split(prng.PRNGKey(0), 1)
    common = ["--policies", "WAM,ECMP", "--draws", "1", "--iterations", "1",
              "--max-shard", "48", "--horizon", "48", "--device", "cpu", "--json"]

    jobsim.main(["--arch", "xlstm-350m", "--scenario", "pfc_storm"] + common
                + [str(tmp_path / "job.json")])
    job = jobs.compile_job("xlstm-350m", workers=4, tp=8, iterations=1, rate=32,
                           max_shard=48)
    topo, sched = scenarios.job_scenarios(workers=4, horizon=2048)["pfc_storm"]
    out = jobs.sweep_job(topo, sched, spec, sp, [job], keys, horizon=48, device="cpu")
    want = {"arch": "xlstm-350m", "scenario": "pfc_storm", "workers": 4, "iterations": 1,
            "compute_ticks": job.compute_ticks, "policies": {
                p.name: {"ettr_mean": float(out["ettr"][i, :, 0].mean()),
                         "ettr_min": float(out["ettr"][i, :, 0].min()),
                         "exposed_ticks_mean": float(out["exposed"][i, :, 0].mean())}
                for i, p in enumerate(policies)}}
    assert json.loads((tmp_path / "job.json").read_text()) == want

    clustersim.main(["--archs", "xlstm-350m,qwen3-8b", "--scenario", "rings_overlapped"]
                    + common + [str(tmp_path / "cluster.json")])
    js = [jobs.compile_job(a, workers=4, tp=8, iterations=1, rate=32, max_shard=48)
          for a in ("xlstm-350m", "qwen3-8b")]
    placed, topo, sched = scenarios.cluster_scenarios(js, horizon=2048)["rings_overlapped"]
    r = cluster.sweep_cluster(topo, sched, spec, sp, placed, keys, 48, device="cpu")
    want = {"archs": ["xlstm-350m", "qwen3-8b"], "scenario": "rings_overlapped",
            "workers": 4, "iterations": 1, "rounds": placed.rounds,
            "finished": bool(np.all(r.finished)), "policies": {
                p.name: {"jobs": {f"job{j}_{cj.job.arch}": {
                    "ettr": float(r.ettr[i, :, j].mean()),
                    "solo_ettr": float(r.solo_ettr[i, :, j].mean()),
                    "slowdown": float(r.slowdown[i, :, j].mean())}
                    for j, cj in enumerate(placed.jobs)},
                    "jain": float(r.jain[i].mean()),
                    "link_util_max": float(r.link_util[i].mean(axis=0).max())}
                for i, p in enumerate(policies)}}
    assert json.loads((tmp_path / "cluster.json").read_text()) == want
    printed = capsys.readouterr().out
    assert "job xlstm-350m: DP=4 TP=8 iterations=1" in printed
    assert "cluster: 2 jobs on 4 leaves, 8 coupled flows, 9 rounds" in printed
