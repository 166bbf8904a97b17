"""Run one cell of the benchmark once and print its result line.

    python3 -m wambench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell (an entry of ``workloads`` in BENCHMARK.json) names a fabric
configuration (``wambench/configs/<config>.json``), a traffic mix
(``wambench/traffic/<mix>.json``) and a chip count; the per-layer metrics
it reports are ``wambench/metrics/<metric>.py``.  All are found by name.

Set-up builds the cell's fabric and flows from the seed, then warms the
program up with one exit chunk of the cell's own shapes.  The window runs
draws 0, 1, 2, ... of the seed back to back through the system's
`run_flows`, each a whole run, until ``--seconds`` have passed; it ends
at the end of a run.  ``--trace 0`` reports the end-to-end metrics,
``--trace 1`` the per-layer ones, read from a profile of whole runs after
the first.  Then a sample of the window's runs, drawn from the seed, is
run again by the plain reference (`wambench.reference`) and compared bit
for bit (`wambench.check`).

The last line of standard output is the result, a JSON object; the
numbers compared, each with its limit, are the last lines of standard
error and the result's last key, ``checks``.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# every cache the program may write lives at a fixed place in the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from wambench import check, roofline, traffic  # noqa: E402
from wambench import trace as tracing  # noqa: E402
from wambench.reference import sim  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole
RESULT_FIELDS = ("cct", "sent_total", "dropped_total", "final_b", "received", "finished",
                 "link_served", "link_busy", "ticks_run")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


# ------------------------------------------------------------------ cells

@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: list
    per_layer: list


def load_cell(name: str, benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of BENCHMARK.json with its configuration, mix and
    metrics read from their files."""
    bench = json.loads(benchmark.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {benchmark.name}: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name, config, mix, int(w["chips"]),
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def fabric_module(config: dict):
    return importlib.import_module(f"wambench.reference.fabrics.{config['fabric']}")


@dataclasses.dataclass
class Shape:
    """The cell's sizes, counted by the benchmark's own code."""

    flows: int
    paths: int
    links: int
    lanes: int
    entries: int
    depth: int
    sm_clock_hz: float


# ---------------------------------------------------------------- program

class Program:
    """The system under test, set up for one cell: its fabric built from
    the flows' leaves, and its sender's settings."""

    def __init__(self, cell: Cell, pairs: np.ndarray, seed: int, device):
        from repro_torch.core.spray import SprayMethod
        from repro_torch.net import topology
        from repro_torch.net.sender import Policy, SenderSpec, run_flows, sender_params

        cfg, mix, s = cell.config, cell.mix, cell.config["sender"]
        self.device, self.mix, self.run_flows = device, mix, run_flows
        self.topo = getattr(topology, cfg["fabric"])(**cfg["sizes"], flow_pairs=pairs,
                                                     **cfg["links"], device=device)
        self.sched = topology.null_schedule(self.topo.links, device=device)
        self.spec = SenderSpec(coded=s["coded"], ell=s["ell"], method=SprayMethod[s["method"]],
                               rate_cap=mix["rate"], early_exit=s["early_exit"],
                               exit_chunk=s["exit_chunk"])
        self.sp = sender_params(Policy[mix["policy"]], rate=mix["rate"], cwnd=s["cwnd"],
                                code_overhead=s["code_overhead"],
                                ctrl_interval=s["ctrl_interval"],
                                seed=traffic.spray_seeds(seed))

    def run(self, key, horizon: int | None = None):
        k = torch.tensor(key, dtype=torch.int64, device=self.device)
        return self.run_flows(self.topo, self.sched, self.spec, self.sp, self.mix["packets"], k,
                              horizon or self.mix["horizon"], device=self.device)


def to_numpy(result) -> dict:
    return {f: getattr(result, f).cpu().numpy() for f in RESULT_FIELDS}


# ------------------------------------------------------------------- run

def flow_ticks_per_s(flows: int, ticks: list, window_s: float) -> float:
    """Simulated work over wall time: every run of the window counts its
    flows times the ticks it ran, over the window's whole length."""
    return flows * sum(ticks) / window_s


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of `FORBIDDEN`."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda", *,
             t0: float | None = None, program_cls=Program) -> dict:
    """Set up, run the window, check, and return the result line's object."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg, mix = cell.config, cell.mix
    fmod = fabric_module(cfg)
    pairs = traffic.leaf_pairs(mix, fmod.leaves(cfg["sizes"]), cfg["hosts_per_leaf"], seed)
    flows = int(pairs.shape[0])
    program = program_cls(cell, pairs, seed, dev)
    # warm-up: one exit chunk of the cell's own shapes builds and loads the
    # kernels, the routing matrix's segments and the allocator's blocks
    program.run(traffic.warmup_key(seed), horizon=cfg["sender"]["exit_chunk"])
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    log(f"[wambench] {cell.name} seed {seed}: {flows} flows, set-up {setup_s:.3f} s")
    peak_setup = torch.cuda.max_memory_allocated(dev) if on_card else 0

    ticks, ends, finished, traced_ticks = [], [], [], 0
    sample = traffic.Sample(seed, int(mix["checked_runs"]))

    def one_run() -> int:
        r = program.run(traffic.run_key(seed, len(ticks)))
        ticks.append(int(r.ticks_run))  # int() waits for the run's end
        ends.append(time.perf_counter())
        finished.append(r.finished)
        sample.offer(len(ticks) - 1, r)
        return ticks[-1]

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    start = time.perf_counter()
    one_run()  # with --trace 1, the first run is not traced
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(tracing.WINDOW):
                traced_from = time.perf_counter()
                traced_ticks += one_run()
                while time.perf_counter() - traced_from < seconds / 4:
                    traced_ticks += one_run()
    else:
        while time.perf_counter() - start < seconds:
            one_run()
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    log(f"[wambench] window {window_s:.3f} s: {len(ticks)} runs, ticks {ticks}, share of "
        f"flows finished {[float(f.float().mean()) for f in finished]}, seconds a "
        f"run {[round(b - a, 4) for a, b in zip([start] + ends, ends)]}")

    # the program's answers to check, then its state freed before the reference runs
    checked = [(i, to_numpy(r)) for i, r in sample.runs()]
    del sample, program, finished
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    fab = sim.Fabric(fmod.build(cfg["sizes"], cfg["links"], pairs), dev)
    card = roofline.card() if on_card else {"sm_clock_hz": 0.0}

    metrics = {}
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                   "count": cell.chips, "memory_peak_bytes": int(max(peak, peak_setup))}
    if on_card:
        device_info["power_limit_w"] = card["power_limit_w"]
    if trace:
        tr = tracing.read(prof, traced_ticks, peak)
        del prof
        gc.collect()
        shape = Shape(flows=fab.F, paths=fab.n, links=fab.L, lanes=int(mix["rate"]),
                      entries=fab.entries, depth=fab.depth, sm_clock_hz=card["sm_clock_hz"])
        for m in cell.per_layer:
            value = importlib.import_module(f"wambench.metrics.{m['name']}").read(tr, shape)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"], device_info["window_s"] = tr.busy_s(), tr.window_s
        log(f"[wambench] traced {traced_ticks} ticks, {len(tr.ops)} device operations, "
            f"busy {tr.busy_s():.6f} of {tr.window_s:.6f} s")
    else:
        for m in cell.end_to_end:
            value = {"flow_ticks_per_s": flow_ticks_per_s(flows, ticks, window_s),
                     "setup_s": setup_s}[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_ref = time.perf_counter()
    layers = check.layers_for(mix["policy"])
    counts, failed = dict.fromkeys(layers, 0), 0
    sa, sb = traffic.spray_seeds(seed)
    for i, got in checked:
        diff = check.compare(got, sim.run(fab, cfg["sender"], mix, traffic.run_key(seed, i),
                                          sa, sb), layers)
        failed += any(diff.values())
        for k, v in diff.items():
            counts[k] += v
    log(f"[wambench] reference: runs {[i for i, _ in checked]} in "
        f"{time.perf_counter() - t_ref:.3f} s")

    checks = {f"{k}_mismatches": {"value": v, "limit": check.LIMIT} for k, v in counts.items()}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": len(ticks), "failed": failed, "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"[wambench] {cell.name} needs {cell.chips} CUDA device(s); found {found}")
        return 3
    torch.set_num_threads(1)  # one process with few threads: the host paces every cell
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0=T0)
    bad = forbidden_modules()
    if bad:
        log(f"[wambench] the process loaded {bad}: the benchmark runs without JAX")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
