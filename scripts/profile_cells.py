"""Where the time goes in the coded, router, dense, zoo, fat-tree, job, cluster and training cells, on one NVIDIA card.

    python3 scripts/profile_cells.py \
        --cell coded|router|prefill|decode|jamba|whisper|fattree|job|cluster|train|
               train_xlstm|train_jamba [--steps N]

Runs one cell of `chip_smoke.py` under `torch.profiler` and prints the
wall time per step, the card's busy and idle shares, the device
operations per step, and those that take the most device time.  A step
is one full-width message encoded on the card from host memory and
peel-decoded on the host (`coded`, default 2), one router window of
`simulate_window` + `report` (`router`, default 50), one full-width
qwen3-8b prefill of 4 x 2,048 tokens (`prefill`, default 3), one
decode step of those 4 sequences after it (`decode`, default 20), one
decode step of the zoo cell's jamba (8 of its 32 layers, after its 4 x
2,048-token prefill) or whisper-large-v3 (after its 1,500 frames and 4 x
384 tokens) (`jamba`, `whisper`, default 20), or one
tick of WAM on the full-width fat-tree family's `inter_pod_uniform`
scenario with the family's telemetry (`fattree`, default 64: one run of
that many ticks, early exit off).  The job and cluster cells report per
tick, over N runs (default 3) of one ring step as their sweeps run it
(early exit in chunks of 16): the full-width qwen3-8b job's first step on
`pfc_storm` under WAM (`job`), and the full-width cluster cell's first
`rings_overlapped` round, both jobs active, under WAM (`cluster`).  A
`train` step is one AdamW step of `chip_smoke.py`'s training cell
(qwen3-8b at published widths, 4 of 36 layers, 4 x 2,048 tokens; default
3, after one warm-up step); `train_xlstm` one AdamW step of xlstm-350m
whole at 8 x 2,048 tokens (default 1: ~6 x 10^6 device operations), and
`train_jamba` one Adafactor step of jamba's period at 2 x 2,048 tokens
(default 2), each after a warm-up step.  The wide cell has its own tool,
`tools/torch_profile_wide.py`.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.train.step import build_decode_step, build_prefill_step  # noqa: E402

UNIT = {"coded": "message", "router": "window", "prefill": "prefill", "decode": "step",
        "jamba": "step", "whisper": "step", "fattree": "tick", "job": "tick", "cluster": "tick",
        "train": "step", "train_xlstm": "step", "train_jamba": "step"}
STEPS = {"coded": 2, "router": 50, "prefill": 3, "decode": 20, "jamba": 20, "whisper": 20,
         "fattree": 64, "job": 3, "cluster": 3, "train": 3, "train_xlstm": 1, "train_jamba": 2}


def _serve_step(cell: str, dev):
    """A full-width prefill, or a decode step after one (bf16 weights only):
    the dense cell's qwen3-8b, or the zoo cell's jamba or whisper."""
    if cell == "jamba":
        cfg = dataclasses.replace(cs.get_config("jamba-v0.1-52b"), n_layers=cs.JAMBA_LAYERS)
        batch, gen = cs._serve_batch(cfg, cs.JAMBA_BATCH, cs.JAMBA_PROMPT, dev), cs.JAMBA_GEN
    elif cell == "whisper":
        cfg = cs.get_config("whisper-large-v3")
        batch = cs._serve_batch(cfg, cs.WHISPER_BATCH, cs.WHISPER_PROMPT, dev,
                                frames=cs.WHISPER_FRAMES)
        gen = cs.WHISPER_GEN
    else:
        cfg = cs.get_config(cs.DENSE_ARCH)
        batch, gen = cs._serve_batch(cfg, cs.DENSE_BATCH, cs.DENSE_PROMPT, dev), cs.DENSE_GEN
    params = cs.M.compute_params(cs.M.init_params(torch.Generator(device=dev).manual_seed(0),
                                                  cfg))
    B, S = batch["tokens"].shape
    cache = cs.M.make_cache(cfg, B, S + gen, device=dev)
    prefill = build_prefill_step(cfg)
    if cell == "prefill":
        return lambda: prefill(params, batch, cache)
    tok, cache, _ = prefill(params, batch, cache)
    decode = build_decode_step(cfg)
    pos = torch.full((B,), S, dtype=torch.int32, device=dev)
    return lambda: decode(params, tok[:, None], pos, cache)  # the same slot each step


def _fat_tree_run(ticks: int, dev):
    """WAM on the full-width inter_pod_uniform scenario for `ticks` ticks."""
    topo, sched = cs.fat_family()["inter_pod_uniform"]
    spec = cs.sender.SenderSpec(rate_cap=cs.FAT_RATE,
                                telemetry=cs.TelemetrySpec(**cs.FAT_TELEMETRY))
    sp = cs.sender.sender_params(cs.Policy.WAM, rate=cs.FAT_RATE)
    key = cs.prng.split(cs.prng.PRNGKey(7), 1)[0]
    return lambda: cs.sender.run_flows(topo, sched, spec, sp, cs.FAT_PACKETS, key, ticks,
                                       device=dev)


def _ring_step(cell: str, dev):
    """One ring step of the job cell (`job`) or one round of the cluster
    cell (`cluster`) under WAM, as the sweeps run it; returns its ticks."""
    spec = cs.sender.SenderSpec(rate_cap=cs.JOB_RATE, early_exit=True,
                                exit_chunk=cs.JOB_EXIT_CHUNK)
    wam = cs.sender.sender_params(cs.Policy.WAM, rate=cs.JOB_RATE)
    key = cs.prng.split(cs.prng.PRNGKey(0), 2)[0].to(dev)
    if cell == "job":
        job = cs.jobs.compile_job(cs.JOB_ARCH, workers=cs.JOB_WORKERS, tp=cs.JOB_TP,
                                  iterations=cs.JOB_ITERATIONS, rate=cs.JOB_RATE,
                                  max_shard=cs.JOB_MAX_SHARD)
        topo, sched = cs.job_scenarios(workers=cs.JOB_WORKERS,
                                       horizon=cs.JOB_HORIZON)["pfc_storm"]
        scheds, shard = cs.jobs.job_step_inputs([job], sched, cs.JOB_HORIZON, device=dev)
        topo = cs.sender.to_device(topo, dev)
        sched0 = cs.sender.EventSchedule(cap_scale=scheds.cap_scale[0, 0],
                                         bg_arrivals=scheds.bg_arrivals[0, 0])
        size, horizon = shard[0, 0], cs.JOB_HORIZON
        key = cs.prng.fold_in(key, 0)
    else:
        js = [cs.jobs.compile_job(a, workers=cs.JOB_WORKERS, tp=cs.JOB_TP,
                                  iterations=cs.JOB_ITERATIONS, rate=cs.JOB_RATE,
                                  max_shard=cs.CLUSTER_MAX_SHARD) for a in cs.CLUSTER_ARCHS]
        placed, topo, sched = cs.cluster_scenarios(js, horizon=cs.JOB_HORIZON)["rings_overlapped"]
        scheds, sizes = cs.cluster.cluster_inputs(placed, sched, cs.CLUSTER_HORIZON, device=dev)
        topo = cs.sender.to_device(topo, dev)
        sched0 = cs.sender.EventSchedule(cap_scale=scheds.cap_scale[0],
                                         bg_arrivals=scheds.bg_arrivals[0])
        size, horizon = sizes[0, 0], cs.CLUSTER_HORIZON
        key = cs.prng.fold_in(key, 0)

    def step():
        r = cs.sender.run_flows_sized(topo, sched0, spec, wam, size, key, horizon, device=dev)
        return int(r.ticks_run)
    return step


def _train_cell(cell: str, dev):
    """A training cell's config and batches: the dense cell (`train`),
    xlstm-350m whole (`train_xlstm`) or jamba's period (`train_jamba`)."""
    if cell == "train":
        return cs.train_cell(dev)
    if cell == "train_xlstm":
        cfg = cs.get_config(cs.XLSTM_ARCH)
        return cfg, cs._train_batches(cfg, cs.XLSTM_BATCH, cs.XLSTM_SEQ, 2, dev)
    cfg = dataclasses.replace(cs.get_config("jamba-v0.1-52b"), n_layers=cs.JAMBA_LAYERS)
    return cfg, cs._train_batches(cfg, cs.JAMBA_TRAIN_BATCH, cs.JAMBA_TRAIN_SEQ, 2, dev)


def _train_step(cell: str, dev):
    """One step of a training cell with its optimizer, on its state (updated
    in place)."""
    cfg, batches = _train_cell(cell, dev)
    opt = cs.make_optimizer(cfg.optimizer, lr=3e-3)
    params = cs.M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    state = [cs.TrainState.create(params, opt.init(params))]
    step = cs.build_train_step(cfg, opt)

    def run():
        state[0], _ = step(state[0], batches[int(state[0].step) % len(batches)])
    return run


def _step(cell: str, dev, steps: int):
    """One step of the cell, built once (for `fattree`, one run of `steps`
    ticks)."""
    if cell.startswith("train"):
        return _train_step(cell, dev)
    if cell == "fattree":
        return _fat_tree_run(steps, dev)
    if cell in ("job", "cluster"):
        return _ring_step(cell, dev)
    if cell in ("prefill", "decode", "jamba", "whisper"):
        return _serve_step(cell, dev)
    if cell == "coded":
        payload, neigh, valid = cs.coded_message()

        def step():
            enc = cs.fountain.encode(payload, neigh, valid, device=dev)
            cs.fountain.peel_decode(cs.fountain.as_uint32(enc), neigh, valid, cs.CODED_K)
        return step
    weights = 0.5 + 1.5 * np.random.default_rng(0).random(cs.ROUTER_REPLICAS)
    router = cs.Router(weights, ell=10, device=dev)
    service = np.full(cs.ROUTER_REPLICAS, 5.0)
    return lambda: router.report(router.simulate_window(cs.ROUTER_BATCH, service))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=tuple(UNIT), required=True)
    ap.add_argument("--steps", type=int, default=None,
                    help="steps to profile (default: coded 2, router 50, prefill 3, fattree 64, jamba 20, "
                    "whisper 20, decode 20, job 3, cluster 3, train 3, train_xlstm 1, "
                    "train_jamba 2)")
    ap.add_argument("--top", type=int, default=12, help="device operations to list (default 12)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_cells: no CUDA device", file=sys.stderr)
        return 2
    steps = args.steps or STEPS[args.cell]
    unit = UNIT[args.cell]
    dev = torch.device("cuda")
    print(cs.card_line())
    step = _step(args.cell, dev, steps)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step()  # warm up: kernel build, allocator, CUDA context
    torch.cuda.synchronize()
    print(f"cell {args.cell}: the warm-up {unit} (builds included) {time.perf_counter() - t0:.3f} s "
          f"unprofiled, peak memory {torch.cuda.max_memory_allocated()} B")
    calls = 1 if args.cell == "fattree" else steps  # a fattree call runs every tick
    # xlstm's step runs ~7 x 10^6 device operations: their host-side events
    # too would not fit the host's memory
    activities = [ProfilerActivity.CUDA]
    if args.cell != "train_xlstm":
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        ticks = [step() for _ in range(calls)]
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if args.cell in ("job", "cluster"):  # per tick, over every run's ticks
        print(f"cell {args.cell}: {calls} runs of {ticks[0]} ticks")
        steps = sum(ticks)
    # the device's events, summed by name straight from the trace (building
    # the profiler's per-event tables for millions of them takes minutes)
    ops: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            us, n = ops.get(e.name(), (0.0, 0))
            ops[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    busy_us = sum(us for us, _ in ops.values())
    print(f"cell {args.cell}: {steps} {unit}s, wall {wall_us / steps:.1f} us/{unit}")
    if busy_us == 0:
        print("device time: not measured (the profiler recorded no device time)")
        return 0
    print(f"device busy {busy_us / steps:.1f} us/{unit}, busy share {busy_us / wall_us:.4f}, "
          f"idle share {1 - busy_us / wall_us:.4f}, device operations "
          f"{sum(n for _, n in ops.values()) / steps:.1f}/{unit}")
    for name, (us, n) in sorted(ops.items(), key=lambda kv: kv[1][0], reverse=True)[:args.top]:
        print(f"  {us / steps:9.2f} us/{unit}  {n / steps:6.1f}/{unit}  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
