"""Quickstart: Whack-a-Mole in 60 seconds, on the PyTorch port.

Spray 10k packets across 5 paths, watch the deterministic counts track the
profile exactly, degrade a path, watch the controller whack it down and
redistribute, then watch it recover.  The port of `examples/quickstart.py`:
the same calls through `repro_torch.core`, on the card unless ``--device
cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (
    PathStats,
    SprayMethod,
    controller_step,
    make_controller,
    make_spray_state,
    path_deviations,
    quantize_profile,
    spray_batch,
)
from repro_torch.device import resolve_device

PACKETS, WHACKS, HEAL_TICKS = 10_240, 4, 30
SHARES = (0.125, 0.390, 0.195, 0.170, 0.120)
# the sizes the CPU tests and chip_smoke.py run
SMOKE = dict(packets=2048)
ELL, SA, SB = 10, 333, 735


def main(argv=None, *, packets: int = PACKETS, whacks: int = WHACKS,
         heal_ticks: int = HEAL_TICKS) -> dict:
    """Run the walkthrough; returns the numbers it printed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}

    # --- 1. a path profile: 5 paths with heterogeneous bandwidth shares ---
    profile = quantize_profile(np.array(SHARES), ell=ELL, device=dev)
    b = profile.b.cpu().numpy()
    out["b"] = b.tolist()
    print("profile b(i):", b, f" (m = {1 << ELL} balls)")

    # --- 2. deterministic spraying with a seeded bit-reversal counter -----
    state = make_spray_state(profile, method=SprayMethod.SHUFFLE_1, sa=SA, sb=SB)
    paths, _, state = spray_batch(state, profile, packets)
    counts = np.bincount(paths.cpu().numpy(), minlength=len(SHARES))
    ideal = b * packets // (1 << ELL)
    out["counts"], out["drift"] = counts.tolist(), int(np.abs(counts - ideal).max())
    print(f"counts after {packets} packets:", counts)
    print(f"ideal (b(i)/m * {packets})    :", ideal)
    print("worst absolute drift      :", out["drift"])

    devs = path_deviations(profile, SprayMethod.SHUFFLE_1, SA, SB)
    out["deviations"] = devs.tolist()
    print(f"provable per-path deviation (any window!): {devs.round(2)} <= ell={ELL}")

    # --- 3. congestion feedback: whack the mole ---------------------------
    f32 = dict(dtype=torch.float32, device=dev)
    ctrl = make_controller(profile)
    bad = PathStats(
        ecn_rate=torch.tensor([0.0, 0.7, 0.0, 0.0, 0.0], **f32),
        loss_rate=torch.tensor([0.0, 0.2, 0.0, 0.0, 0.0], **f32),
        rtt=torch.tensor([10.0, 45.0, 10.0, 11.0, 10.0], **f32),
    )
    print("\npath 1 congests (ECN 70%, loss 20%, RTT 4.5x)...")
    out["whacked"] = []
    for tick in range(whacks):
        ctrl, w = controller_step(ctrl, bad)
        out["whacked"].append(ctrl.profile.b.cpu().numpy().tolist())
        print(f"  whack {tick}: b = {np.asarray(out['whacked'][-1])}")

    # --- 4. recovery: the path heals, allocation ramps back ---------------
    healthy = PathStats(ecn_rate=torch.zeros(5, **f32), loss_rate=torch.zeros(5, **f32),
                        rtt=torch.full((5,), 10.0, **f32))
    print("path 1 heals (EWMA hysteresis delays trust, then ramps)...")
    out["healing"] = []
    for tick in range(heal_ticks):
        ctrl, w = controller_step(ctrl, healthy)
        if tick % 6 == 5:
            row = (ctrl.profile.b.cpu().numpy().tolist(), float(w[1]))
            out["healing"].append(row)
            print(f"  tick {tick}: b = {np.asarray(row[0])}  w1={row[1]:.3f}")
    out["recovered"] = ctrl.profile.b.cpu().numpy().tolist()
    print("  recovered profile:", np.asarray(out["recovered"]),
          " (sum still", int(sum(out["recovered"])), ")")
    return out


if __name__ == "__main__":
    main()
