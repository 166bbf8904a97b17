"""Cluster-level CLI: J co-scheduled jobs contending on ONE fabric.

Compiles each model config into its collective schedule
(`repro_torch.net.jobs.compile_job`), places all of them on one shared
leaf-spine fabric (`repro_torch.net.cluster`), runs every concurrently
active ring step as coupled flows under a cluster scenario
(`repro_torch.net.scenarios.cluster_scenarios`), and prints per-job ETTR,
solo-run ETTR, cross-job slowdown, Jain fairness and the hottest link's
utilization (`cluster.sweep_cluster`).  The port of the JAX package's
`launch/clustersim.py`: the same arguments, lines and ``--json`` payload,
plus ``--device`` (default ``cuda``); ``--devices N`` runs the sweep
flow-sharded over N ranks on that device (`sender.flow_mesh`),
bit-identical to the unsharded sweep.

    PYTHONPATH=src python -m repro_torch.launch.clustersim \\
        --archs xlstm-350m,qwen3-8b --scenario rings_overlapped

    PYTHONPATH=src python -m repro_torch.launch.clustersim \\
        --archs qwen3-8b,qwen3-8b --scenario staggered_start \\
        --policies WAM,ECMP --draws 1 --max-shard 48 --horizon 256 \\
        --device cpu --json out.json
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch import random as prng
from repro_torch.net.cluster import sweep_cluster
from repro_torch.net.jobs import compile_job
from repro_torch.net.scenarios import CLUSTER_SCENARIO_NAMES, cluster_scenarios
from repro_torch.net.sender import SenderSpec, flow_mesh, sender_params, stack_params
from repro_torch.net.transport import Policy

__all__ = ["main"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--archs", default="xlstm-350m,qwen3-8b",
                    help="comma-separated model configs, one job each")
    ap.add_argument("--scenario", default="rings_overlapped")
    ap.add_argument("--policies", default="ECMP,RR,RAND_STATIC,RAND_ADAPTIVE,WAM",
                    help="comma-separated Policy names")
    ap.add_argument("--workers", type=int, default=4, help="DP degree per job")
    ap.add_argument("--tp", type=int, default=8, help="model-parallel degree")
    ap.add_argument("--iterations", type=int, default=1)
    ap.add_argument("--draws", type=int, default=2, help="PRNG repeats")
    ap.add_argument("--rate", type=int, default=32)
    ap.add_argument("--max-shard", type=int, default=256)
    ap.add_argument("--horizon", type=int, default=1024)
    ap.add_argument("--stagger", type=int, default=None,
                    help="staggered_start offset in ring steps "
                         "(default: half of job 0's schedule)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", metavar="PATH", help="also dump results as JSON")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="run the sweep flow-sharded over N ranks on --device "
                         "(sender.flow_mesh; bit-identical results)")
    args = ap.parse_args(argv)

    if args.scenario not in CLUSTER_SCENARIO_NAMES:
        ap.error(
            f"--scenario {args.scenario!r}: choose from "
            f"{CLUSTER_SCENARIO_NAMES}"
        )
    mesh = None
    if args.devices is not None:
        mesh = flow_mesh(args.devices, device=args.device)
        print(f"devices: {args.devices} flow ranks on {args.device} "
              f"(flow-sharded sweep, bit-identical to unsharded)")
    policies = [Policy[p.strip()] for p in args.policies.split(",")]
    archs = [a.strip() for a in args.archs.split(",")]
    jobs = [
        compile_job(
            a, workers=args.workers, tp=args.tp, iterations=args.iterations,
            rate=args.rate, max_shard=args.max_shard,
        )
        for a in archs
    ]
    scens = cluster_scenarios(
        jobs, horizon=max(args.horizon, 2048), stagger_steps=args.stagger
    )
    cluster, topo, sched = scens[args.scenario]

    print(f"cluster: {len(jobs)} jobs on {cluster.n_leaves} leaves, "
          f"{cluster.flows} coupled flows, {cluster.rounds} rounds")
    for j, cj in enumerate(cluster.jobs):
        job = cj.job
        print(f"  job {j} {job.arch}: DP={job.workers} "
              f"leaves={list(cj.leaves)} start_step={cj.start_step} "
              f"steps={job.total_steps} "
              f"ratio={job.compute_comm_ratio:.2f}")

    spec = SenderSpec(rate_cap=args.rate)
    sp = stack_params([sender_params(p, rate=args.rate) for p in policies])
    keys = prng.split(prng.PRNGKey(args.seed), args.draws)
    r = sweep_cluster(topo, sched, spec, sp, cluster, keys, args.horizon,
                      device=args.device, mesh=mesh)

    print(f"\nscenario {args.scenario} ({args.draws} draws, "
          f"horizon {args.horizon}):")
    if not bool(np.all(r.finished)):
        print("  WARNING: some flows hit the horizon sentinel — numbers "
              "below are bounds, not measurements (raise --horizon)")
    rows = {}
    for i, pol in enumerate(policies):
        per_job = {}
        for j, cj in enumerate(cluster.jobs):
            per_job[f"job{j}_{cj.job.arch}"] = {
                "ettr": float(r.ettr[i, :, j].mean()),
                "solo_ettr": float(r.solo_ettr[i, :, j].mean()),
                "slowdown": float(r.slowdown[i, :, j].mean()),
            }
        rows[pol.name] = {
            "jobs": per_job,
            "jain": float(r.jain[i].mean()),
            "link_util_max": float(r.link_util[i].mean(axis=0).max()),
        }
        jobs_str = "  ".join(
            f"{k.split('_')[0]} ETTR {v['ettr']:.4f} "
            f"(solo {v['solo_ettr']:.4f}, x{v['slowdown']:.2f})"
            for k, v in per_job.items()
        )
        print(f"  {pol.name:<14} {jobs_str}  jain {rows[pol.name]['jain']:.4f}"
              f"  util_max {rows[pol.name]['link_util_max']:.2f}")

    if args.json:
        payload = {
            "archs": archs, "scenario": args.scenario,
            "workers": args.workers, "iterations": args.iterations,
            "rounds": cluster.rounds,
            "finished": bool(np.all(r.finished)),
            "policies": rows,
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
