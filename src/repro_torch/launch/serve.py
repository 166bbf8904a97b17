"""Batched serving launcher: prefill + greedy decode with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        --batch 4 --prompt-len 2048 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --smoke \\
        --device cpu

The port of the JAX package's `launch/serve.py`: the same flow and
printout (prefill and decode times and tokens/s, the first generated
tokens), on the card unless ``--device cpu``.  Weights are random, drawn
from a seeded `torch.Generator` on the device; prompts come from
``np.random.default_rng(0)``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.train.step import build_decode_step, build_prefill_step

__all__ = ["Generation", "prompts", "generate", "main"]


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor  # int32 [B, G]: the prefill's token, then one per decode step
    logits: torch.Tensor  # f32 [G, B, V]: the logits each token was taken from
    cache: dict           # the KV caches after the last step
    prefill_s: float      # host clock around the prefill, synchronised
    decode_s: float       # host clock around the G - 1 decode steps, synchronised


def prompts(cfg: ArchConfig, batch: int, prompt_len: int, device) -> torch.Tensor:
    """int32 prompts [batch, prompt_len] from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.integers(1, cfg.vocab_size, (batch, prompt_len)),
                           dtype=torch.int32, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params: dict, cfg: ArchConfig, tokens: torch.Tensor, gen: int, *,
             plain: bool = False, forced: torch.Tensor | None = None) -> Generation:
    """Prefill ``tokens`` [B, S], then decode ``gen - 1`` greedy tokens.

    With ``forced`` [B, gen], step g is fed ``forced[:, g]`` instead of its
    own greedy token (teacher forcing: two runs then see the same inputs).
    ``plain=True`` runs the attention kernels' plain versions."""
    dev = tokens.device
    B, S = tokens.shape
    prefill = build_prefill_step(cfg, plain=plain)
    decode = build_decode_step(cfg, plain=plain)
    cache = M.make_cache(cfg, B, S + gen, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    tok, cache, logits = prefill(params, {"tokens": tokens}, cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    out, kept = [tok], [logits]
    t0 = time.perf_counter()
    for g in range(gen - 1):
        feed = tok if forced is None else forced[:, g]
        pos = torch.full((B,), S + g, dtype=torch.int32, device=dev)
        tok, cache, logits = decode(params, feed[:, None], pos, cache)
        out.append(tok)
        kept.append(logits)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return Generation(torch.stack(out, dim=1), torch.stack(kept), cache, t_prefill, t_decode)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = M.compute_params(
        M.init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg))
    B, S, G = args.batch, args.prompt_len, args.gen
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run = generate(params, cfg, prompts(cfg, B, S, dev), G)
    gen = run.tokens.cpu().numpy()
    print(f"arch={cfg.name} batch={B} prompt={S} gen={G} device={dev}")
    print(f"prefill: {run.prefill_s * 1e3:.1f} ms ({B * S / run.prefill_s:.0f} tok/s)")
    print(f"decode : {run.decode_s * 1e3:.1f} ms total, "
          f"{run.decode_s * 1e3 / max(G - 1, 1):.3f} ms per token "
          f"({B * (G - 1) / max(run.decode_s, 1e-9):.0f} tok/s)")
    if dev.type == "cuda":
        print(f"peak device memory: {torch.cuda.max_memory_allocated(dev)} B "
              f"({torch.cuda.get_device_name(dev)})")
    print("first generated tokens:", gen[:, :8].tolist())


if __name__ == "__main__":
    main()
