"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, mix and metric found by its name."""
import importlib
import json
import re

import numpy as np
import pytest

from wambench import roofline, run, traffic
from wambench import trace as tracing

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")


def test_benchmark_json_meets_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (run.ROOT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) and not w.startswith("/") for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((run.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    assert len(names) == len(BENCH["configs"])
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) == len(BENCH["end_to_end"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= {w["name"] for w in cells}
    for w in cells:
        mine = [m for m in metrics if w["name"] in m.get("workloads", [w["name"]])]
        assert any(m["name"] == "setup_s" for m in mine)
        assert any(m["name"] != "setup_s" for m in mine if m in BENCH["end_to_end"])
        assert any(m in BENCH["per_layer"] for m in mine)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(name):
    cell = run.load_cell(name)
    w = {c["name"]: c for c in BENCH["workloads"]}[name]
    conf = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert cell.config["name"] == conf["name"] and cell.config["reduced"] == conf["reduced"]
    assert run.fabric_module(cell.config).leaves(cell.config["sizes"]) >= 2
    assert cell.mix["policy"] in ("WAM", "ECMP")
    assert {m["name"] for m in cell.end_to_end} == {"flow_ticks_per_s", "setup_s"}
    assert cell.per_layer


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    reader = importlib.import_module(f"wambench.metrics.{metric['name']}")
    assert reader.UNIT == metric["unit"] and reader.MOVES == metric["moves"]
    empty = tracing.Trace(ops=[], window_s=0.0, ticks=0, peak_bytes=0)
    shape = run.Shape(flows=8, paths=4, links=16, lanes=4, entries=64, depth=8,
                      sm_clock_hz=1.98e9)
    assert reader.read(empty, shape) is None  # nothing to read: no value, never 0


def _trace():
    ops = [("spray_select_kernel", 0, 10), ("link_fold_kernel", 5, 20),
           ("elementwise", 30, 40), ("link_fold_kernel", 100, 110)]
    return tracing.Trace(ops=ops, window_s=200e-9, ticks=2, peak_bytes=3 * 2 ** 30,
                         gap_labels=["a", "b", "aten::add", "aten::is_nonzero"])


def test_trace_arithmetic():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(40e-9)  # [0, 20] + [30, 40] + [100, 110]
    assert tr.op_seconds(("link_fold",)) == pytest.approx(25e-9)
    assert tr.top_ops()[0] == ["link_fold_kernel", pytest.approx(25e-9)]
    assert tr.idle_gaps() == [["aten::is_nonzero", pytest.approx(60e-9)],
                              ["aten::add", pytest.approx(10e-9)]]


def test_metric_values_on_a_trace():
    tr = _trace()
    shape = run.Shape(flows=8, paths=4, links=16, lanes=4, entries=64, depth=8,
                      sm_clock_hz=2e9)
    read = {m["name"]: importlib.import_module(f"wambench.metrics.{m['name']}").read(tr, shape)
            for m in BENCH["per_layer"]}
    assert read["device_ops_per_tick"] == 2.0
    assert read["device_idle_pct"] == pytest.approx(80.0)
    assert read["peak_mem_gib"] == 3.0
    spray = 2 * 8 * (24 + 16 + 16) / roofline.HBM_BYTES_PER_S
    assert read["spray_roofline_pct"] == pytest.approx(100 * spray / 10e-9)
    fold = max(4 * (128 + 48 + 1) / roofline.HBM_BYTES_PER_S, 8 * 4 / 2e9)
    assert read["link_sum_roofline_pct"] == pytest.approx(100 * 2 * 2 * fold / 25e-9)


def test_rate_is_the_window_s_work_over_its_time():
    assert run.flow_ticks_per_s(8192, [128, 64, 128], 2.0) == 8192 * 320 / 2.0


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 40 + 3, -3])
def test_traffic_from_the_seed(seed):
    for mix, leaves, per_leaf, k in (({"pattern": "permutation"}, 512, 16, 1),
                                     ({"pattern": "permutation", "fanout": 8}, 16, 4, 8)):
        pairs = traffic.host_pairs(mix, leaves, per_leaf, seed)
        hosts = leaves * per_leaf
        assert pairs.shape == (hosts * k, 2)
        assert np.array_equal(pairs, traffic.host_pairs(mix, leaves, per_leaf, seed))
        assert not np.any(pairs[:, 0] // per_leaf == pairs[:, 1] // per_leaf)
        assert np.array_equal(pairs[:, 0], np.repeat(np.arange(hosts), k))
        for i in range(k):  # each of the k layers is a permutation
            assert np.array_equal(np.sort(pairs[i::k, 1]), np.arange(hosts))
    keys = {traffic.run_key(seed, d) for d in range(16)} | {traffic.warmup_key(seed)}
    assert len(keys) == 17 and all(0 <= k < 2 ** 32 for kk in keys for k in kk)
    def sample(runs):
        s = traffic.Sample(seed, 2)
        for i in range(runs):
            s.offer(i, f"answer {i}")
        return s.runs()

    assert sample(1) == [(0, "answer 0")]
    picked = sample(40)
    assert picked == sample(40) and len(picked) == 2 and picked[0][0] < picked[1][0]
    assert all(a == f"answer {i}" for i, a in picked)


def test_no_card_no_result(capsys):
    if run.torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names():
    ok = {"repro_torch": 0, "repro_torch.net": 0, "reproducible": 0, "numpy": 0}
    assert run.forbidden_modules(ok) == []
    bad = {"repro": 0, "repro.net": 0, "jax.numpy": 0, "jaxlib": 0, "flax.linen": 0}
    assert run.forbidden_modules({**ok, **bad}) == sorted(bad)


class _Event:
    def __init__(self, kind, name, a, b, corr=0):
        self.kind, self._name, self.a, self.b, self.corr = kind, name, a, b, corr

    def device_type(self):
        on_card = self.kind in ("kernel", "gpu_memcpy", "gpu_user_annotation")
        return run.torch.autograd.DeviceType.CUDA if on_card else run.torch.autograd.DeviceType.CPU

    def name(self):
        return self._name

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a

    def correlation_id(self):
        return self.corr


def test_trace_read_names_gaps_by_the_launching_host_op():
    events = [_Event("user_annotation", tracing.WINDOW, 0, 1000),
              _Event("gpu_user_annotation", tracing.WINDOW, 0, 1000),
              _Event("cpu_op", "aten::add", 10, 50), _Event("cpu_op", "aten::empty", 12, 14),
              _Event("cuda_runtime", "cudaLaunchKernel", 20, 30, 1),
              _Event("kernel", "add_kernel", 100, 200, 1),
              _Event("cpu_op", "aten::item", 300, 400),
              _Event("cuda_runtime", "cudaMemcpyAsync", 310, 390, 2),
              _Event("gpu_memcpy", "Memcpy DtoH", 500, 520, 2),
              _Event("kernel", "late_kernel", 990, 1100, 3)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    tr = tracing.read(Prof, ticks=4, peak_bytes=1)
    assert [op[0] for op in tr.ops] == ["add_kernel", "Memcpy DtoH"]
    assert tr.window_s == pytest.approx(1e-6) and tr.busy_s() == pytest.approx(120e-9)
    assert tr.idle_gaps() == [["aten::item", pytest.approx(300e-9)]]
