"""Job-level ETTR in 60 seconds, on the PyTorch port.

Compile one model's training step into its collective schedule, run it
against an uncontended fabric and a PFC pause storm, and compare whole-job
ETTR for deterministic spraying (WAM) vs flow-hash routing (ECMP): the
paper's headline claim at job scope, spraying keeps the accelerators fed
when the fabric misbehaves.  The port of `examples/job_ettr_quickstart.py`:
the same calls through `repro_torch.net`, on the card unless ``--device
cpu``; each ring step stops once its flows finish (``early_exit``, which
changes no ETTR: the CPU tests hold it against the reference's own calls).

    PYTHONPATH=src python examples/torch_job_ettr_quickstart.py [--device cpu]
"""
import argparse

from repro_torch import random as prng
from repro_torch.device import resolve_device
from repro_torch.net.jobs import compile_job, run_job
from repro_torch.net.scenarios import job_scenarios
from repro_torch.net.sender import SenderSpec, sender_params
from repro_torch.net.transport import Policy

WORKERS, RATE, HORIZON = 4, 32, 512
ARCH, MAX_SHARD = "qwen3-8b", 96
SCENARIOS = ("uncontended", "pfc_storm")
# the sizes the CPU tests and chip_smoke.py run
SMOKE = dict(horizon=32, max_shard=16, scenarios=("pfc_storm",))


def main(argv=None, *, horizon: int = HORIZON, max_shard: int = MAX_SHARD,
         scenarios=SCENARIOS) -> dict:
    """Compile the job and run it under each scenario and policy; returns
    the schedule's numbers and each scenario's ETTR per policy."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. compile the job: bytes + roofline -> schedule of collectives --
    job = compile_job(ARCH, workers=WORKERS, tp=8, iterations=1, rate=RATE,
                      max_shard=max_shard)
    out = {"compute_ticks": job.compute_ticks, "ratio": job.compute_comm_ratio,
           "phases": [(ph.kind, ph.ring_steps, ph.shard_packets, ph.overlap_ticks)
                      for ph in job.phases], "ettr": {}}
    print(f"{job.arch}: compute window {job.compute_ticks:.0f} ticks/iteration, "
          f"compute:comm ratio {job.compute_comm_ratio:.2f}")
    for ph in job.phases:
        print(f"  {ph.kind:<10} {ph.ring_steps} ring steps x "
              f"{ph.shard_packets} pkt, may hide under "
              f"{ph.overlap_ticks:.0f} ticks of compute")

    # --- 2. run it: every ring step on the shared leaf-spine fabric -------
    scens = job_scenarios(workers=WORKERS, horizon=2048)
    spec = SenderSpec(rate_cap=RATE, early_exit=True)
    key = prng.PRNGKey(0)
    print(f"\n{'scenario':<22} {'ECMP ETTR':>10} {'WAM ETTR':>10}")
    for name in scenarios:
        topo, sched = scens[name]
        row = {}
        for pol in (Policy.ECMP, Policy.WAM):
            r = run_job(topo, sched, spec, sender_params(pol, rate=RATE), job, key,
                        horizon=horizon, device=dev)
            row[pol.name] = float(r.ettr)
        out["ettr"][name] = row
        print(f"{name:<22} {row['ECMP']:>10.4f} {row['WAM']:>10.4f}")

    print("\nECMP pins each worker's flow to one spine: collisions (and any "
          "event\nthat kills that spine) stall the whole synchronous job, while "
          "WAM's\ndeterministic spray spreads every shard over all healthy "
          "paths.")
    return out


if __name__ == "__main__":
    main()
