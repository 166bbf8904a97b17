"""Run every `examples/torch_*.py` at its defaults and print each one's wall
time, beside the card's name and power limit.

    python3 scripts/run_examples.py [--device cuda] [--only NAME ...]

Each example's ``main`` runs in this process, in the order of the
reference's examples, with ``--device`` (and `train_tiny_lm` with a
checkpoint directory under ``build/``); its own printout passes through
(serving prints its prefill time and decode tokens/s, training its seconds
a step).  The wall time is the host clock around ``main``, synchronised on
the card, its first build of the kernels included for the first example
that launches one.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

EXAMPLES = ("quickstart", "telemetry_quickstart", "topology_scenarios_demo",
            "collective_cct_demo", "job_ettr_quickstart", "cluster_contention_demo",
            "serve_batched", "train_tiny_lm")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", os.path.join(ROOT, "examples", f"torch_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", nargs="*", choices=EXAMPLES, default=list(EXAMPLES))
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    card = card_line() if dev.type == "cuda" else "CPU"
    print(f"[examples] {card}", flush=True)
    ckpt = os.path.join(ROOT, "build", "run_examples", "tiny_lm")
    shutil.rmtree(ckpt, ignore_errors=True)
    walls = {}
    for name in args.only:
        argv = ["--device", args.device]
        if name == "train_tiny_lm":
            argv += ["--ckpt-dir", ckpt]
        print(f"== {name} {' '.join(argv)}", flush=True)
        t0 = time.perf_counter()
        _example(name).main(argv)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        walls[name] = time.perf_counter() - t0
        print(f"[examples] {name}: {walls[name]:.1f} s wall ({card})", flush=True)
    print(f"[examples] wall times (s): {walls}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
