"""The plain reference against the program at CPU sizes, its ordered link
fold, and the control: the reference in bfloat16 comes out not correct."""
import numpy as np
import pytest
import torch
from _wambench_tiny import CELLS, tiny_cell

from wambench import check, control, run
from wambench.reference import sim


@pytest.mark.parametrize("name", sorted(CELLS))
def test_tiny_cell_agrees_with_the_reference(name):
    result = run.run_cell(tiny_cell(name), 2 ** 33 + 17, 0.0, False, "cpu")
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    layers = check.layers_for(CELLS[name][1]["policy"])
    assert result["checks"] == {f"{k}_mismatches": {"value": 0, "limit": 0} for k in layers}
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"flow_ticks_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def _left_fold(vals, route, base, L):
    flat, out = vals.reshape(-1).numpy(), base.numpy().copy()
    depth = np.bincount(route.reshape(-1), minlength=L)
    for i, link in enumerate(route.reshape(-1)):
        out[link] = np.float32(out[link] + flat[i])
    shallow = depth < depth.max()
    out[shallow] = out[shallow] + np.float32(0.0)
    return out


@pytest.mark.parametrize("deep", [30, 10 ** 9])
def test_link_sum_is_the_ordered_fold(deep, monkeypatch):
    monkeypatch.setattr(sim, "DEEP", deep)
    rng = np.random.default_rng(5)
    L = 12
    route = rng.integers(0, L, (3, 20, 4))
    route[1, :, 0] = 3  # one deep link
    spec = dict(route=route, latency=np.zeros((20, 4), np.int32), fb_delay=8, ring_len=16,
                **{k: np.ones(L, np.float32) for k in ("capacity", "queue_limit",
                                                      "ecn_threshold", "degrade_p",
                                                      "recover_p", "degrade_factor")})
    fab = sim.Fabric(spec, "cpu")
    assert len(fab.parts) == (2 if deep == 30 else 1)
    vals = torch.as_tensor(rng.standard_normal((3, 20, 4)).astype(np.float32) * 1e3)
    base = torch.as_tensor(rng.standard_normal(L).astype(np.float32))
    base[:4] = -0.0
    got = fab.link_sum(vals, base).numpy()
    assert np.array_equal(got.view(np.int32), _left_fold(vals, route, base, L).view(np.int32))


@pytest.mark.parametrize("name", ["fat_tree.perm_wam", "leaf_spine.fanout_wam"])
def test_control_is_not_correct(name):
    """The control (the reference with the fabric's state in bfloat16)
    fails the check on every seed tried, and the program passes it."""
    for seed in (11, 12, 13):
        out = control.readings(tiny_cell(name), seed, "cpu")
        assert max(out["program"].values()) == check.LIMIT
        assert max(out["control"].values()) > check.LIMIT, out


def test_traced_run_on_the_cpu():
    """A traced run on the CPU drives the profiler and every reader: no
    device operation, so no per-layer value, and the check still runs."""
    result = run.run_cell(tiny_cell("fat_tree.perm_wam"), 5, 0.0, True, "cpu")
    assert result["correct"] and result["metrics"] == {}
    assert result["breakdown"] == {"device_ops": [], "idle_gaps": []}
    assert result["device"]["busy_s"] == 0.0 and result["device"]["window_s"] > 0
