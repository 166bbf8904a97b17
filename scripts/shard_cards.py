"""Flow-sharded runs across the cards of one machine, against the unsharded
runs: what `chip_smoke.py` (one card) cannot reach.

    python3 scripts/shard_cards.py        # needs at least two cards

Cases: five flows, one of size 0, on an NCCL rank a card; a 64-flow
fat-tree family (four scenarios, ECMP and WAM) on an NCCL rank a card
and on gloo ranks two a card; `sweep_job` / `sweep_cluster` over an NCCL
rank a card at the CPU tests' sizes against the CPU; and a rank that
raises, which must reach the caller.  Each case runs in a subprocess of
its own with a time limit (a hang prints every thread's stack) and prints
its wall time beside the card's name and power limit.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = r'''
import faulthandler, os, sys, time
faulthandler.dump_traceback_later(90, exit=True)
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as cs
from repro_torch import random as prng
from repro_torch.kernels import build
from repro_torch.net import sender as S, scenarios as SC, topology as T
from repro_torch.net.policies import Policy
from repro_torch.ranks import run_ranks
build.build_all(["link_fold", "spray_select"])
dev = torch.device("cuda", 0)
cards = torch.cuda.device_count()


def padded(mesh):
    topo = T.leaf_spine(4, 2, cs.SHARD_PAIRS)
    args = (topo, T.null_schedule(topo.links),
            S.SenderSpec(rate_cap=cs.SHARD_RATE, early_exit=True, exit_chunk=16),
            S.sender_params(Policy.WAM, rate=cs.SHARD_RATE),
            torch.tensor(cs.SHARD_SIZES, dtype=torch.int32), prng.PRNGKey(4), cs.SHARD_HORIZON)
    want = S.run_flows_sized(*args, device=dev)
    t0 = time.perf_counter()
    cs._equal_runs(want, S.shard_run_flows(*args, mesh=mesh), "five flows")
    return time.perf_counter() - t0


def family(mesh):
    fam = SC.stack_scenarios(list(SC.fat_tree_scenarios(flows=64, n_pods=4,
                                                        horizon=256).values()))
    spec = S.SenderSpec(rate_cap=16, early_exit=True)
    sp = S.policy_sweep_params((Policy.ECMP, Policy.WAM), rate=16)
    keys = prng.split(prng.PRNGKey(5), 1)
    want = S.sweep_flows_scenarios(*fam, spec, sp, 16, keys, 256, device=dev)
    t0 = time.perf_counter()
    cs._equal_runs(want, S.shard_sweep_flows_scenarios(*fam, spec, sp, 16, keys, 256,
                                                       mesh=mesh), "64-flow family")
    return time.perf_counter() - t0


def jobs_cluster(mesh):
    t0 = time.perf_counter()
    job, cluster = cs._shard_job_cluster(mesh)
    secs = time.perf_counter() - t0
    job_cpu, cluster_cpu = cs._shard_job_cluster(None)
    assert all(np.array_equal(job_cpu[k], job[k]) for k in job_cpu)
    for k in ("ettr", "solo_ettr", "slowdown", "jain", "link_util", "finished"):
        assert np.array_equal(getattr(cluster_cpu, k), getattr(cluster, k)), k
    return secs


def failing(mesh):
    def body(comm):
        x = comm.all_gather(torch.ones(3, device=comm.device), 0)
        if comm.rank == 1:
            raise ValueError("rank 1 fails")
        return comm.all_gather(x, 0)

    t0 = time.perf_counter()
    try:
        run_ranks(mesh, body)
    except ValueError:
        return time.perf_counter() - t0
    raise AssertionError("the failing rank's error did not reach the caller")
'''

CASES = (
    ("five flows, an NCCL rank a card", "padded(S.flow_mesh(timeout=60))"),
    ("64-flow fat-tree family, an NCCL rank a card", "family(S.flow_mesh(timeout=60))"),
    ("64-flow fat-tree family, gloo ranks two a card",
     "family(S.flow_mesh(2 * cards, timeout=60))"),
    ("sweep_job / sweep_cluster, an NCCL rank a card, against the CPU",
     "jobs_cluster(S.flow_mesh(timeout=60))"),
    ("a failing rank, NCCL ranks", "failing(S.flow_mesh(timeout=60))"),
)


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke

    if torch.cuda.device_count() < 2:
        print("shard_cards: needs at least two cards", file=sys.stderr)
        return 2
    print(f"{torch.cuda.device_count()} x {chip_smoke.card_line()}", flush=True)
    failed = 0
    for name, call in CASES:
        code = PRELUDE + f"print(f'{{{call}:.2f}} s', flush=True)\n"
        try:
            p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                               text=True, timeout=120)
        except subprocess.TimeoutExpired as e:
            failed += 1
            print(f"[{name}] timed out\n{e.stderr or ''}", flush=True)
            continue
        if p.returncode:
            failed += 1
            print(f"[{name}] failed\n{p.stdout[-1500:]}\n{p.stderr[-4000:]}", flush=True)
        else:
            print(f"[{name}] equal: {p.stdout.strip().splitlines()[-1]}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
