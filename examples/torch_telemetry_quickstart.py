"""Watch the whack happen: in-run telemetry on a flapping link, on the
PyTorch port.

Eight senders share a leaf-spine fabric while spine 0 flaps: it loses
capacity for half of every period, the mole that keeps returning to the
same hole.  With `SenderSpec.telemetry` set, the sender engine records
per-tick series as it runs (on stride ticks): per-path allocation,
per-link queue depth / ECN marks / drops, ARQ debt, and the online
windowed discrepancy gauge (the counterpart of the paper's §9 deviation
bound).  The port of `examples/telemetry_quickstart.py`: the same calls
through `repro_torch.net`, on the card unless ``--device cpu``; its JSONL
and trace files are byte-equal to the reference's.

The script prints, per policy:

  * recovery ticks: event onset -> allocation profile re-converged
    (ECMP's allocation never moves, so it "recovers" instantly; WAM's
    whack/restore response is the number that matters);
  * the discrepancy-gauge max (how far realized spraying strayed from
    the commanded profile) and hot-link queue percentiles.

and exports each series under traces/demo/ as a JSONL store plus a
Chrome/Perfetto trace (open the *.trace.json in ui.perfetto.dev to see
the flap edges as instant markers over the queue/allocation counters).

    PYTHONPATH=src python examples/torch_telemetry_quickstart.py [--device cpu]
    python tools/torch_trace_report.py --summary traces/demo/*.jsonl
"""
import argparse
import json
import os
import time

import numpy as np

from repro_torch import random as prng
from repro_torch.device import resolve_device
from repro_torch.net import (
    SenderSpec,
    TelemetrySpec,
    chrome_trace,
    event_onsets,
    frame_select,
    policy_sweep_params,
    queue_percentiles,
    recovery_ticks,
    series,
    summarize_recovery,
    sweep_flows,
    write_series_jsonl,
)
from repro_torch.net.scenarios import link_flap
from repro_torch.net.transport import Policy

POLICIES = (Policy.ECMP, Policy.RAND_STATIC, Policy.WAM)
HORIZON = 1024
N_PACKETS = 512
OUT = os.path.join("traces", "demo")
# the sizes the CPU tests and chip_smoke.py run
SMOKE = dict(horizon=128, n_packets=32)


def main(argv=None, *, horizon: int = HORIZON, n_packets: int = N_PACKETS,
         out_dir: str = OUT) -> dict:
    """Run the sweep, print the table and write the exports under
    ``out_dir``; returns each policy's printed numbers."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    topo, sched = link_flap(flows=8, n_spines=4, period=64, horizon=horizon)
    spec = SenderSpec(rate_cap=32, early_exit=True,
                      telemetry=TelemetrySpec(stride=2, window=horizon // 2))
    sp = policy_sweep_params(POLICIES, rate=32)
    keys = prng.split(prng.PRNGKey(0), 1)

    print("== link_flap with in-run telemetry: one run a policy ==")
    t0 = time.perf_counter()
    _, frame = sweep_flows(topo, sched, spec, sp, n_packets, keys, horizon=horizon,
                           device=dev)
    print(f"   {len(POLICIES)} policies x 8 flows in "
          f"{time.perf_counter() - t0:.2f}s (capture included)\n")

    onsets = event_onsets(sched)
    tol = (1 << spec.ell) / 32  # re-converged = within m/32 per path
    os.makedirs(out_dir, exist_ok=True)
    print(f"{'policy':12s} {'samples':>7s} {'events':>6s} {'recovered':>9s} "
          f"{'rec_p50':>7s} {'rec_max':>7s} {'disc_max':>8s} {'q_hot_p99':>9s}")
    out = {}
    for pi, pol in enumerate(POLICIES):
        ser = series(frame_select(frame, (pi, 0)))
        rec = summarize_recovery(recovery_ticks(ser["tick"], ser["alloc"], onsets, tol=tol))
        qp = queue_percentiles(ser)
        row = dict(samples=len(ser["tick"]), events=rec["events"],
                   recovered=rec["recovered_frac"], p50=rec["p50"], max=rec["max"],
                   disc_max=float(np.max(ser["disc"])), q_hot_p99=qp["hot_p99"])
        out[pol.name] = row
        print(f"{pol.name:12s} {row['samples']:7d} {row['events']:6d} "
              f"{row['recovered']:9.2f} {row['p50']:7.1f} "
              f"{row['max']:7.1f} {row['disc_max']:8.2f} "
              f"{row['q_hot_p99']:9.1f}")
        stem = os.path.join(out_dir, f"flap_{pol.name}")
        write_series_jsonl(
            stem + ".jsonl", ser,
            meta={"name": f"demo/flap/{pol.name}", "policy": pol.name,
                  "onsets": onsets.tolist(), "tol": tol},
        )
        with open(stem + ".trace.json", "w") as f:
            json.dump(chrome_trace(ser, onsets=onsets, max_links=4), f)

    print(f"\nwrote JSONL series + Perfetto traces under {out_dir}/")
    print(f"inspect:  python tools/torch_trace_report.py --summary "
          f"{out_dir}/*.jsonl")
    print("visualize: load a *.trace.json in https://ui.perfetto.dev")
    return out


if __name__ == "__main__":
    main()
