"""The check's two readings at a cell's own size, on the card.

    python3 -m wambench.control --workload <name> --seeds <n> [<n> ...]

For each seed: the program's run of the seed's first draw against the
plain reference (the lower reading, which has to be 0), and the control,
the reference with the fabric's float state in bfloat16, against the
reference (the upper reading, which has to fail).  One JSON line a seed:
the differing elements of each layer, program and control, and the ticks
each ran.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from wambench import check, run, traffic
from wambench.reference import sim


def readings(cell: run.Cell, seed: int, device) -> dict:
    dev = torch.device(device)
    cfg, mix = cell.config, cell.mix
    fmod = run.fabric_module(cfg)
    pairs = traffic.leaf_pairs(mix, fmod.leaves(cfg["sizes"]), cfg["hosts_per_leaf"], seed)
    key, (sa, sb) = traffic.run_key(seed, 0), traffic.spray_seeds(seed)
    program = run.Program(cell, pairs, seed, dev)
    got = run.to_numpy(program.run(key))
    del program
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    fab = sim.Fabric(fmod.build(cfg["sizes"], cfg["links"], pairs), dev)
    want = sim.run(fab, cfg["sender"], mix, key, sa, sb)
    low = sim.run(fab, cfg["sender"], mix, key, sa, sb, lowp=True)
    layers = check.layers_for(mix["policy"])
    return {"seed": seed, "program": check.compare(got, want, layers),
            "control": check.compare(low, want, layers),
            "ticks": [int(x["ticks_run"]) for x in (got, want, low)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = run.load_cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        out = readings(cell, seed, "cuda")
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
