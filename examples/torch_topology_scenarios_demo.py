"""Flows that contend: the scenario library on the shared leaf-spine
fabric, on the PyTorch port.

Eight senders incast into one destination leaf; ECMP flows collide on the
shared spine->leaf downlinks while Whack-a-Mole sprays the aggregate evenly.
Then a ring all-reduce where one worker straggles: contention every policy
must route around, not an independent Markov draw per worker.

The port of `examples/topology_scenarios_demo.py`: the same calls through
`repro_torch.net`, on the card unless ``--device cpu``.  `sweep_flows`
runs every (policy, draw) of a scenario one after another (the reference
compiles them into one program), each stopping once its flows finish
(``early_exit``: a tick of the port costs a few milliseconds of host time,
and the reference's horizon-long runs would take minutes; no cct changes,
as the CPU tests hold against the reference's own calls).

    PYTHONPATH=src python examples/torch_topology_scenarios_demo.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch import random as prng
from repro_torch.device import resolve_device
from repro_torch.net import (
    CollectiveConfig,
    SenderSpec,
    TransportConfig,
    allreduce_cct_shared,
    policy_sweep_params,
    sweep_flows,
)
from repro_torch.net.scenarios import SCENARIOS, straggler_worker
from repro_torch.net.transport import Policy

N_PACKETS = 512
DRAWS = 4
POLICIES = (Policy.ECMP, Policy.WAM)
HORIZON = 2048
SHARD_PACKETS = 256
# the sizes the CPU tests and chip_smoke.py run
SMOKE = dict(n_packets=16, draws=1, horizon=48, shard_packets=8,
             scenarios=("incast",))


def main(argv=None, *, n_packets: int = N_PACKETS, draws: int = DRAWS,
         horizon: int = HORIZON, shard_packets: int = SHARD_PACKETS,
         scenarios=tuple(SCENARIOS)) -> dict:
    """Run the scenario sweep and the straggler all-reduce; returns each
    scenario's cct percentiles per policy and each policy's all-reduce cct."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {"scenarios": {}, "straggler": {}}

    print(f"== scenario sweep: per-flow CCT p50/p99 over {draws} draws ==")
    print("   (every policy and draw of a scenario, one run after another)")
    keys = prng.split(prng.PRNGKey(0), draws)
    spec = SenderSpec(rate_cap=32, early_exit=True)
    sp = policy_sweep_params(POLICIES, rate=32)
    for name in scenarios:
        topo, sched = SCENARIOS[name]()
        t0 = time.perf_counter()
        r = sweep_flows(topo, sched, spec, sp, n_packets, keys, horizon=horizon, device=dev)
        cct = r.cct.cpu().numpy()  # [policy, draw, flow]
        dt = time.perf_counter() - t0
        row = [f"{name:22s} F={topo.flows} L={topo.links:3d}"]
        out["scenarios"][name] = {}
        for pi, pol in enumerate(POLICIES):
            flat = cct[pi].reshape(-1)
            p50, p99 = float(np.percentile(flat, 50)), float(np.percentile(flat, 99))
            out["scenarios"][name][pol.name] = (p50, p99)
            row.append(f"{pol.name}: p50={p50:6.1f} p99={p99:6.1f}")
        row.append(f"[{dt:5.2f}s]")
        print("  ".join(row))

    print("\n== ring all-reduce with a straggler worker (shared fabric) ==")
    topo, sched = straggler_worker(workers=4, n_spines=4, factor=0.25)
    ccfg = CollectiveConfig(workers=4, shard_packets=shard_packets, horizon=horizon)
    for pol in POLICIES:
        total, per_step, finished = allreduce_cct_shared(
            topo, sched, TransportConfig(policy=pol, rate=32, early_exit=True), ccfg,
            prng.PRNGKey(1),
            device=dev)
        note = "" if bool(finished.all()) else "  (hit horizon!)"
        out["straggler"][pol.name] = (float(total), float(per_step.max()),
                                      bool(finished.all()))
        print(f"{pol.name:5s} total CCT = {float(total):7.1f}"
              f"  per-step max = {float(per_step.max()):6.1f}{note}")
    return out


if __name__ == "__main__":
    main()
