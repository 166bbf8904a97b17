"""End-to-end training on the PyTorch port: a ~100M-param LM for a
few hundred steps.

    PYTHONPATH=src python examples/torch_train_tiny_lm.py               # quick 20M
    PYTHONPATH=src python examples/torch_train_tiny_lm.py --size 100m --steps 300

Demonstrates the full substrate on one card: model zoo config -> data
pipeline -> train step (remat + microbatch) -> async atomic checkpoints ->
kill-and-resume fault tolerance (rerun with --resume).  The port of
`examples/train_tiny_lm.py`: the same sizes, flags, checkpoint cadence and
checkpoint format, on the card unless ``--device cpu``.  Weights are
random, drawn from a seeded `torch.Generator` on the device
(`models.model.init_params`: the reference's tree, not its numbers);
`train` takes any parameter tree, so a caller can hand it the reference's
weights (`convert.model_params`).
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch import tree
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.data.pipeline import SyntheticLM, host_batch
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.api import make_optimizer
from repro_torch.train.state import TrainState
from repro_torch.train.step import build_train_step

SIZES = {
    # ~20M: quick demo
    "20m": dict(n_layers=6, d_model=384, n_heads=6, n_kv_heads=2, d_ff=1536,
                vocab_size=16384),
    # ~100M: the brief's end-to-end target (use --steps 300)
    "100m": dict(n_layers=10, d_model=640, n_heads=10, n_kv_heads=2,
                 d_ff=2560, vocab_size=32000),
}
LOG_EVERY, CKPT_EVERY = 20, 50
# the run the CPU tests and chip_smoke.py make: a 2-layer model, 4 steps of
# 4 x 64 tokens (the CPU train tests' batches), every loss printed, a
# checkpoint every 2 steps
SMOKE_SIZES = {"smoke": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                             vocab_size=256)}
SMOKE_ARGV = ["--size", "smoke", "--steps", "4", "--seq-len", "64", "--batch", "4"]
SMOKE = dict(sizes=SMOKE_SIZES, log_every=1, ckpt_every=2)


def tiny_config(size: str, sizes=SIZES) -> ArchConfig:
    return ArchConfig(name=f"tiny-lm-{size}", family="dense",
                      period=(LayerSpec("attn", "mlp"),), mlp_kind="swiglu", **sizes[size])


def train(params: dict, cfg: ArchConfig, *, steps: int, seq_len: int, batch: int,
          ckpt_dir: str, resume: bool = False, log_every: int = LOG_EVERY,
          ckpt_every: int = CKPT_EVERY) -> dict:
    """AdamW at lr 3e-3 on `SyntheticLM` batches from ``params`` (updated in
    place, on their device) up to step ``steps``, resumed from the latest
    checkpoint under ``ckpt_dir`` if ``resume``; an async checkpoint every
    ``ckpt_every`` steps and a final one.  Returns the losses it printed
    (by step) and the final step."""
    dev = tree.leaves(params)[0].device
    n = sum(x.numel() for x in tree.leaves(params))
    print(f"model: {n / 1e6:.1f}M params, seq={seq_len}, batch={batch}")

    opt = make_optimizer("adamw", lr=3e-3)
    state = TrainState.create(params, opt.init(params))
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=batch)
    step = build_train_step(cfg, opt)

    start = 0
    if resume and ckpt.latest_step(ckpt_dir):
        state = ckpt.restore(ckpt_dir, state)
        start = int(state.step)
        print(f"resumed at step {start}")

    losses = {}
    t0, pending = time.time(), None
    for i in range(start, steps):
        state, m = step(state, host_batch(ds, i, device=dev))
        if (i + 1) % log_every == 0:
            losses[i + 1] = float(m["loss"])  # waits for the step
            dt = (time.time() - t0) / log_every
            t0 = time.time()
            print(f"step {i + 1:4d}  loss {losses[i + 1]:.4f}  ({dt:.2f} s/step)")
        if (i + 1) % ckpt_every == 0:
            if pending:
                pending.join()
            pending = ckpt.save_async(state, ckpt_dir, i + 1)
    if pending:
        pending.join()
    ckpt.save(state, ckpt_dir, int(state.step))
    print(f"done at step {int(state.step)}; checkpoints in {ckpt_dir}")
    return {"losses": losses, "step": int(state.step)}


def main(argv=None, *, sizes=SIZES, log_every: int = LOG_EVERY,
         ckpt_every: int = CKPT_EVERY) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", choices=list(sizes), default="20m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "wam_tiny_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = tiny_config(args.size, sizes)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    return train(params, cfg, steps=args.steps, seq_len=args.seq_len, batch=args.batch,
                 ckpt_dir=args.ckpt_dir, resume=args.resume, log_every=log_every,
                 ckpt_every=ckpt_every)


if __name__ == "__main__":
    main()
