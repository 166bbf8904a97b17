"""Job-level ETTR CLI: compile a training step, run it on the fabric.

Turns a model config into a per-iteration collective schedule
(`repro_torch.net.jobs.compile_job`), runs it against a job scenario
(`repro_torch.net.scenarios.job_scenarios`) for each requested policy,
and prints the compiled schedule plus per-policy ETTR and exposed
communication (`jobs.sweep_job`).  The port of the JAX package's
`launch/jobsim.py`: the same arguments, lines and ``--json`` payload,
plus ``--device`` (default ``cuda``).  ``--devices N`` runs the sweep
flow-sharded over N ranks on that device (`sender.flow_mesh`: threads with
private process groups; ranks beyond the cards share them), bit-identical
to the unsharded sweep, so it is an execution knob, not a model change.

    PYTHONPATH=src python -m repro_torch.launch.jobsim \\
        --arch qwen3-8b --scenario link_flap --workers 4 --iterations 2

    PYTHONPATH=src python -m repro_torch.launch.jobsim --arch xlstm-350m \\
        --scenario link_flap --policies WAM,ECMP --draws 1 --max-shard 48 \\
        --horizon 256 --device cpu --json out.json

    PYTHONPATH=src python -m repro_torch.launch.jobsim --arch xlstm-350m \\
        --policies WAM,ECMP --draws 1 --max-shard 48 --horizon 256 \\
        --device cpu --devices 2
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch import random as prng
from repro_torch.net.jobs import compile_job, step_table, sweep_job, total_packets
from repro_torch.net.scenarios import JOB_SCENARIO_NAMES, job_scenarios
from repro_torch.net.sender import SenderSpec, flow_mesh, sender_params, stack_params
from repro_torch.net.transport import Policy

__all__ = ["main"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--scenario", default="link_flap")
    ap.add_argument("--policies", default="ECMP,RR,RAND_STATIC,RAND_ADAPTIVE,WAM",
                    help="comma-separated Policy names")
    ap.add_argument("--workers", type=int, default=4, help="DP degree")
    ap.add_argument("--tp", type=int, default=8, help="model-parallel degree")
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--draws", type=int, default=2, help="PRNG repeats")
    ap.add_argument("--rate", type=int, default=32)
    ap.add_argument("--max-shard", type=int, default=512)
    ap.add_argument("--horizon", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", metavar="PATH", help="also dump results as JSON")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="run the sweep flow-sharded over N ranks on --device "
                         "(sender.flow_mesh; bit-identical results)")
    args = ap.parse_args(argv)

    if args.scenario not in JOB_SCENARIO_NAMES:
        ap.error(
            f"--scenario {args.scenario!r}: choose from {JOB_SCENARIO_NAMES}"
        )
    mesh = None
    if args.devices is not None:
        mesh = flow_mesh(args.devices, device=args.device)
        print(f"devices: {args.devices} flow ranks on {args.device} "
              f"(flow-sharded sweep, bit-identical to unsharded)")
    policies = [Policy[p.strip()] for p in args.policies.split(",")]
    job = compile_job(
        args.arch, workers=args.workers, tp=args.tp,
        iterations=args.iterations, rate=args.rate,
        max_shard=args.max_shard,
    )
    shard, _, offsets = step_table(job)
    print(f"job {job.arch}: DP={job.workers} TP={args.tp} "
          f"iterations={job.iterations}")
    print(f"  compute window  {job.compute_ticks:8.1f} ticks "
          f"(compute:comm ratio {job.compute_comm_ratio:.2f}, "
          f"tick = {job.tick_seconds * 1e6:.1f} us)")
    for ph in job.phases:
        print(f"  {ph.kind:<10} {ph.ring_steps} steps x {ph.shard_packets} "
              f"pkt/worker, overlap window {ph.overlap_ticks:.1f} ticks")
    print(f"  total {total_packets(job)} packets over "
          f"{job.total_steps} ring steps; planned span "
          f"{int(offsets[-1])}+ ticks")

    scens = job_scenarios(
        workers=args.workers, horizon=max(args.horizon, 2048)
    )
    topo, sched = scens[args.scenario]
    spec = SenderSpec(rate_cap=args.rate)
    sp = stack_params([sender_params(p, rate=args.rate) for p in policies])
    keys = prng.split(prng.PRNGKey(args.seed), args.draws)
    out = sweep_job(topo, sched, spec, sp, [job], keys, horizon=args.horizon,
                    device=args.device, mesh=mesh)

    print(f"\nscenario {args.scenario} ({args.draws} draws, "
          f"horizon {args.horizon}):")
    if not bool(np.all(out["finished"])):
        print("  WARNING: some ring steps hit the horizon sentinel — ETTR "
              "below is an upper bound, not a measurement (raise --horizon)")
    rows = {}
    for i, pol in enumerate(policies):
        ettr = out["ettr"][i, :, 0]
        exposed = out["exposed"][i, :, 0]
        rows[pol.name] = {
            "ettr_mean": float(ettr.mean()),
            "ettr_min": float(ettr.min()),
            "exposed_ticks_mean": float(exposed.mean()),
        }
        print(f"  {pol.name:<14} ETTR {ettr.mean():.4f} "
              f"(min {ettr.min():.4f})  exposed comm "
              f"{exposed.mean():8.1f} ticks")
    if args.json:
        payload = {
            "arch": job.arch, "scenario": args.scenario,
            "workers": job.workers, "iterations": job.iterations,
            "compute_ticks": job.compute_ticks,
            "policies": rows,
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
