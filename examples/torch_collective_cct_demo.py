"""The paper's motivating scenario, end to end, on the PyTorch port: a
distributed-training ring all-reduce over a degrading multipath fabric,
ECMP vs Whack-a-Mole.

The port of `examples/collective_cct_demo.py`: the same calls through
`repro_torch.net`, on the card unless ``--device cpu``.  Each message stops
once it is delivered (``early_exit``: 768 messages of a 4,096-tick horizon
would take hours of the port's host-bound ticks; no cct changes, as the
CPU tests hold against the reference's own calls).

    PYTHONPATH=src python examples/torch_collective_cct_demo.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.device import resolve_device
from repro_torch.net import (
    CollectiveConfig,
    FabricParams,
    TransportConfig,
    allreduce_cct,
    ettr,
    ideal_step_ticks,
)
from repro_torch.net.transport import Policy

POLICIES = (Policy.ECMP, Policy.RR, Policy.RAND_ADAPTIVE, Policy.WAM)
SHARD_PACKETS, HORIZON, SEEDS = 512, 4096, 4
COMPUTE_TICKS = 500.0  # per training iteration
# the sizes the CPU tests and chip_smoke.py run
SMOKE = dict(shard_packets=8, horizon=16, seeds=1, policies=(Policy.WAM,))


def fabric(device) -> FabricParams:
    """8 paths a link with long-lived congestion moles."""
    def full(v, dtype=torch.float32):
        return torch.full((8,), v, dtype=dtype, device=device)

    return FabricParams(
        capacity=full(8.0), latency=full(4, torch.int32), queue_limit=full(48.0),
        ecn_threshold=full(12.0),
        degrade_p=full(0.003),    # long-lived congestion "moles"
        recover_p=full(0.005), degrade_factor=full(0.05), fb_delay=8, ring_len=128)


def main(argv=None, *, shard_packets: int = SHARD_PACKETS, horizon: int = HORIZON,
         seeds: int = SEEDS, policies=POLICIES) -> dict:
    """Every policy x reliability over ``seeds`` draws; returns each row's
    mean cct and ETTR (and the ideal cct)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    params = fabric(dev)
    ccfg = CollectiveConfig(workers=4, shard_packets=shard_packets, horizon=horizon)
    ideal = 6 * ideal_step_ticks(params, shard_packets, 48)
    out = {"ideal": ideal, "rows": {}}

    print(f"ring all-reduce, 4 workers, 8 paths/link, ideal CCT = {ideal:.0f} ticks")
    print(f"{'policy':<14} {'reliability':<12} {'mean CCT':>9} {'ETTR':>6}")
    for pol in policies:
        for coded in (False, True):
            tcfg = TransportConfig(policy=pol, coded=coded, rate=48, early_exit=True)
            totals = [float(allreduce_cct(params, tcfg, ccfg, prng.PRNGKey(s), device=dev)[0])
                      for s in range(seeds)]
            e = ettr(COMPUTE_TICKS, np.asarray(totals), ideal)
            rel = "coded" if coded else "arq"
            out["rows"][f"{pol.name}/{rel}"] = (float(np.mean(totals)), float(e))
            print(f"{pol.name:<14} {rel:<12} {np.mean(totals):>9.0f} {e:>6.3f}")
    print("\n(the paper's claim: spraying + erasure coding is what keeps CCT "
          "near-optimal and GPUs busy)")
    return out


if __name__ == "__main__":
    main()
