"""Every golden trace reproduced by the port on the CPU, bit for bit."""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.net import transport as tt  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _load_gen():
    spec = importlib.util.spec_from_file_location(
        "gen_golden_transport", os.path.join(GOLDEN_DIR, "gen_golden_transport.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GEN = _load_gen()
GOLDEN = {f: np.load(os.path.join(GOLDEN_DIR, f"transport_{f}.npz"))
          for f in ("seed", "policies")}
FAB_FIELDS = ("capacity", "latency", "queue_limit", "ecn_threshold", "degrade_p",
              "recover_p", "degrade_factor")


def port_config(cfg) -> tt.TransportConfig:
    return tt.TransportConfig(
        policy=tt.Policy(int(cfg.policy)), coded=cfg.coded,
        code_overhead=cfg.code_overhead, rate=cfg.rate, ell=cfg.ell,
        ctrl_interval=cfg.ctrl_interval, method=int(cfg.method), seed=cfg.seed,
        cwnd=cfg.cwnd)


def port_fabric(p):
    return convert.fabric_params({k: np.asarray(getattr(p, k)) for k in FAB_FIELDS},
                                 fb_delay=p.fb_delay, ring_len=p.ring_len)


def port_topo(t):
    arrays = {k: np.asarray(getattr(t, k)) for k in ("route",) + FAB_FIELDS}
    return convert.topology_params(arrays, fb_delay=t.fb_delay, ring_len=t.ring_len)


def assert_fields(r, golden, name):
    for field in GEN.FIELDS:
        got = getattr(r, field).numpy()
        want = golden[f"{name}/{field}"]
        assert got.dtype == want.dtype and np.array_equal(got, want), (name, field, got, want)


def _params(file, cases):
    return [pytest.param(file, c, id=c[0].replace("/", "-")) for c in cases]


MESSAGE_CASES = (_params("seed", GEN.golden_cases())
                 + _params("policies", GEN.golden_policy_cases()))


@pytest.mark.parametrize("file,case", MESSAGE_CASES)
def test_simulate_message_golden(file, case):
    name, params, cfg, n_packets, seed, horizon = case
    r = tt.simulate_message(port_fabric(params), port_config(cfg), n_packets,
                            prng.PRNGKey(seed), horizon, device="cpu")
    assert_fields(r, GOLDEN[file], name)


FLOW_CASES = (_params("seed", [("FLOWS/WAM",) + tuple(GEN.golden_flows_case())])
              + _params("policies", GEN.golden_policy_flows_cases()))


@pytest.mark.parametrize("file,case", FLOW_CASES)
def test_simulate_flows_golden(file, case):
    name, topo, sched, cfg, n_packets, seed, horizon = case
    tsched = convert.event_schedule({"cap_scale": np.asarray(sched.cap_scale),
                                     "bg_arrivals": np.asarray(sched.bg_arrivals)})
    r = tt.simulate_flows(port_topo(topo), tsched, port_config(cfg), n_packets,
                          prng.PRNGKey(seed), horizon, device="cpu")
    assert_fields(r, GOLDEN[file], name)
