"""Train launcher: the port of the JAX package's `launch/train.py`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --smoke \\
        --steps 100 --ckpt-dir /tmp/ckpt [--resume] [--device cpu]

The same flow and flags: the synthetic data pipeline -> the train step
(AdamW for ``--smoke``, else the config's optimizer, at ``--lr`` with the
cosine schedule) -> async checkpoints every ``--ckpt-every`` steps and a
final one.  It runs on the card unless ``--device cpu``.  Weights are
random, drawn from a seeded `torch.Generator` on the device.  A vision
model's patches and an enc-dec model's frames are zero stubs
(`host_batch`'s ``extra``).  Kill and restart with ``--resume``: the run
continues from the latest checkpoint bit for bit, since every batch is a
pure function of its step.  The reference's ``--sprayed-dp`` (data
parallelism over `repro.dist`, which the tree does not hold) is not
ported.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import tree
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.pipeline import SyntheticLM, host_batch
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.optim.api import make_optimizer
from repro_torch.train.state import TrainState
from repro_torch.train.step import build_train_step

__all__ = ["modality_stubs", "main"]


def modality_stubs(cfg, batch: int, seq_len: int) -> dict:
    """``host_batch``'s ``extra`` for the config's frontend: zero patches
    (a prefix of ``min(prefix_tokens, seq_len // 2)`` positions) or zero
    frames (``seq_len`` of them), as the serving CLI builds them."""
    if cfg.frontend == "vision_patches":
        return {"patches": ((batch, min(cfg.prefix_tokens, seq_len // 2), cfg.d_model),
                            COMPUTE_DTYPE)}
    if cfg.is_encdec:
        return {"frames": ((batch, seq_len, cfg.d_model), COMPUTE_DTYPE)}
    return {}


def main(argv=None) -> TrainState:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt = make_optimizer(cfg.optimizer if not args.smoke else "adamw", lr=args.lr)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    state = TrainState.create(params, opt.init(params))
    n_params = sum(x.numel() for x in tree.leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={dev}")

    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                     global_batch=args.global_batch)
    extra = modality_stubs(cfg, args.global_batch, args.seq_len)
    step = build_train_step(cfg, opt, microbatch=args.microbatch)

    start = 0
    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir):
        state = ckpt.restore(args.ckpt_dir, state)
        start = int(state.step)
        print(f"resumed from step {start}")

    pending = None
    t0 = time.time()
    for i in range(start, args.steps):
        state, metrics = step(state, host_batch(ds, i, extra, device=dev))
        if (i + 1) % args.log_every == 0:
            dt = (time.time() - t0) / args.log_every
            t0 = time.time()
            print(f"step {i + 1:5d} loss={float(metrics['loss']):.4f} ({dt:.2f}s/step)")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = ckpt.save_async(state, args.ckpt_dir, i + 1)
    if pending is not None:
        pending.join()
    if args.ckpt_dir:
        ckpt.save(state, args.ckpt_dir, args.steps)
        print(f"final checkpoint at step {args.steps}")
    return state


if __name__ == "__main__":
    main()
