"""Where the time goes in the port's full-width cell, on one NVIDIA card.

    python3 tools/torch_profile_wide.py [--ticks 64]

Runs the WAM full-width cell of `chip_smoke.py` (4,096 flows, 64 leaves x
16 spines) for a short horizon under `torch.profiler` and prints the wall
time per tick, the card's busy and idle shares, the kernels launched per
tick, and the kernels that take the most device time.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_wide: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs.card_line())
    topo = cs.leaf_spine(cs.WIDE_LEAVES, cs.WIDE_SPINES, cs.wide_pairs(), uplink_capacity=8.0,
                         degrade_p=0.002, device=dev)
    sched = cs.null_schedule(topo.links, device=dev)
    cfg = cs.TransportConfig(policy=cs.Policy.WAM, rate=cs.WIDE_RATE)

    def run():
        r = cs.simulate_flows(topo, sched, cfg, cs.WIDE_PACKETS, cs.prng.PRNGKey(0),
                              args.ticks, device=dev)
        torch.cuda.synchronize()
        return r

    run()  # warm up: kernel build, allocator, CUDA context
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA") and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"ticks {args.ticks}, wall {wall_us / args.ticks:.1f} us/tick")
    if busy_us == 0:
        print("device time: not measured (the profiler recorded no kernel time)")
        return 0
    print(f"device busy {busy_us / args.ticks:.1f} us/tick, busy share {busy_us / wall_us:.4f}, "
          f"idle share {1 - busy_us / wall_us:.4f}, kernel launches {launches / args.ticks:.1f}/tick")
    for e in sorted(kernels, key=_device_us, reverse=True)[:12]:
        print(f"  {_device_us(e) / args.ticks:9.2f} us/tick  {e.count / args.ticks:6.1f}/tick  "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
