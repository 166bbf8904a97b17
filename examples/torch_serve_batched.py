"""Batched serving example on the PyTorch port: prefill a batch of prompts,
decode with a KV cache (ring buffer for SWA archs), report throughput.

The port of `examples/serve_batched.py`: the same flags and printout, on
the card unless ``--device cpu``.  Weights are random, drawn from a seeded
`torch.Generator` on the device (`models.model.init_params`: the
reference's tree, not its numbers); `serve` takes any parameter tree, so a
caller can hand it the reference's weights (`convert.model_params`).

    PYTHONPATH=src python examples/torch_serve_batched.py --arch h2o-danube-3-4b
"""
import argparse

import torch

from repro_torch.configs.registry import ARCH_IDS, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import generate, serve_batch
from repro_torch.models import model as M

# the sizes the CPU tests and chip_smoke.py run (qwen3-8b's smoke config)
SMOKE = dict(batch=2, prompt_len=16, gen=8)


def serve(params: dict, cfg, batch: int, prompt_len: int, gen: int, device, *,
          forced: torch.Tensor | None = None) -> dict:
    """Prefill ``batch`` prompts of ``prompt_len`` positions with ``params``
    (compute dtypes, `models.model.compute_params`), decode ``gen - 1``
    greedy tokens (teacher-forced on ``forced`` [B, gen] if given), print
    the times and the first generations.  Returns the tokens (int32 [B,
    gen]) and the logits they were taken from (f32 [gen, B, V])."""
    B, S, G = batch, prompt_len, gen
    if cfg.window:
        print(f"SWA arch: ring-buffer KV cache capacity = {min(cfg.window, S + G)}")
    run = generate(params, cfg, serve_batch(cfg, B, S, device), G, forced=forced)
    print(f"prefill {B}x{S}: {run.prefill_s * 1e3:.0f} ms")
    print(f"decode {G - 1} steps: {run.decode_s * 1e3:.0f} ms "
          f"-> {B * (G - 1) / max(run.decode_s, 1e-9):.0f} tok/s (batch aggregate)")
    tokens = run.tokens.cpu().numpy()
    print("sample generations (first 10 token ids):")
    for row in tokens[:3, :10]:
        print("  ", row.tolist())
    return {"tokens": tokens, "logits": run.logits.cpu().numpy()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-8b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    params = M.compute_params(M.init_params(torch.Generator(device=dev).manual_seed(0), cfg))
    return serve(params, cfg, args.batch, args.prompt_len, args.gen, dev)


if __name__ == "__main__":
    main()
