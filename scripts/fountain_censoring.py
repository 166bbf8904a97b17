"""How often LT peeling fails inside `decode_overhead_curve`'s stream.

    python3 scripts/fountain_censoring.py [--device cpu] [--trials 3] [--seed 0]

For each K, runs the port's `decode_overhead_curve(K, trials,
default_rng(seed))` and, drawing the same payload and encodings again,
peel-decodes each trial's whole stream of R = int(1.6K) + 32 symbols.  A
trial whose whole stream does not decode is reported by the curve as R
(censored), as in the reference.  Prints one line per K and a JSON
summary; the counts do not depend on the device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch.net import fountain  # noqa: E402


def censoring(K: int, trials: int, seed: int, device) -> dict:
    R = int(K * 1.6) + 32
    need = fountain.decode_overhead_curve(K, trials, np.random.default_rng(seed), device=device)
    rng = np.random.default_rng(seed)  # the curve's draws, in its order
    payload = rng.integers(0, 2**32, (K, 8), dtype=np.uint32)
    decoded = []
    for _ in range(trials):
        neigh, valid = fountain.sample_encoding(K, R, rng)
        enc = fountain.as_uint32(fountain.encode(payload, neigh, valid, device=device))
        decoded.append(fountain.peel_decode(enc, neigh, valid, K) is not None)
    return dict(K=K, R=R, need=need.tolist(), decoded_within_R=decoded,
                censored=int(sum(not d for d in decoded)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--K", type=int, nargs="+", default=[256, 1024, 2048, 4096, 8192])
    args = ap.parse_args()
    rows = []
    for K in args.K:
        row = censoring(K, args.trials, args.seed, args.device)
        rows.append(row)
        print(f"K {K}: R {row['R']}, curve {row['need']}, whole stream decoded "
              f"{sum(row['decoded_within_R'])} of {args.trials}")
    print(json.dumps({"seed": args.seed, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
