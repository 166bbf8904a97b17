"""How far bf16 rounding alone moves qwen3-8b's logits at full width, on one NVIDIA card.

    python3 scripts/dense_noise_floor.py

Runs `chip_smoke.py`'s full-width dense cell (qwen3-8b, 36 layers, 4
prompts of 2,048 tokens, 64 greedy tokens) with the attention kernels,
then again teacher-forced on those tokens with other attention in the
prefill: the plain versions (f32), the plain version computed in float64,
and `scaled_dot_product_attention` (a yardstick only: the port never
calls it).  Decode steps use `flash_decode`'s plain version in every
teacher-forced run.  For each pair of runs it prints the largest and the
rms logit difference (over all 64 steps and at the first step) and the
share of equal greedy tokens.  Every run starts from the same bf16
weights; a difference between two runs is the rounding of their
attention outputs, grown through the layers.
"""
from __future__ import annotations

import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.models import layers  # noqa: E402


def _causal_only(causal, window, scale, q_offset):
    if window is not None or scale is not None or q_offset or not causal:
        raise ValueError("these variants cover causal attention with no window only")


def _f64_attention(q, k, v, *, causal=True, window=None, scale=None, q_offset=0):
    """The quadratic form in float64, cast to q's type."""
    _causal_only(causal, window, scale, q_offset)
    group = q.shape[1] // k.shape[1]
    S = q.shape[2]
    qd = q.double() / math.sqrt(q.shape[-1])
    kd = k.double().repeat_interleave(group, dim=1)
    vd = v.double().repeat_interleave(group, dim=1)
    logits = qd @ kd.transpose(-1, -2)
    future = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax(logits.masked_fill_(future, float("-inf")), dim=-1)
    return (probs @ vd).to(q.dtype)


def _sdpa(q, k, v, *, causal=True, window=None, scale=None, q_offset=0):
    _causal_only(causal, window, scale, q_offset)
    return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)


def _forced(params, cfg, tokens, forced, prefill_attention):
    """A teacher-forced plain run whose prefill attention is ``prefill_attention``."""
    plain = layers.flash_attention_plain
    layers.flash_attention_plain = prefill_attention
    try:
        run = cs.generate(params, cfg, tokens, cs.DENSE_GEN, plain=True, forced=forced)
    finally:
        layers.flash_attention_plain = plain
    run.cache = None
    return run


def _compare(name, a, b):
    d = (a.logits - b.logits).float()
    rms_all = float(d.pow(2).mean().sqrt())
    print(f"{name}: max |diff| {float(d.abs().max())} (first step "
          f"{float(d[0].abs().max())}), rms {rms_all} (first step "
          f"{float(d[0].pow(2).mean().sqrt())}); equal greedy tokens "
          f"{float((a.tokens == b.tokens).float().mean())}")


def main() -> int:
    if not torch.cuda.is_available():
        print("dense_noise_floor: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs.card_line())
    cfg = cs.get_config(cs.DENSE_ARCH)
    params = cs.M.compute_params(cs.M.init_params(torch.Generator(device=dev).manual_seed(0),
                                                  cfg))
    tokens = cs.prompts(cfg, cs.DENSE_BATCH, cs.DENSE_PROMPT, dev)
    kernels = cs.generate(params, cfg, tokens, cs.DENSE_GEN)
    kernels.cache = None
    print(f"logits over {cs.DENSE_GEN} steps: std {float(kernels.logits.std())}, max |logit| "
          f"{float(kernels.logits.abs().max())}")
    runs = {"plain f32": _forced(params, cfg, tokens, kernels.tokens, cs.flash_attention_plain),
            "plain f64": _forced(params, cfg, tokens, kernels.tokens, _f64_attention),
            "sdpa": _forced(params, cfg, tokens, kernels.tokens, _sdpa)}
    for name, run in runs.items():
        _compare(f"kernels vs {name}", kernels, run)
    _compare("sdpa vs plain f32", runs["sdpa"], runs["plain f32"])
    _compare("plain f32 vs plain f64", runs["plain f32"], runs["plain f64"])
    _compare("sdpa vs plain f64", runs["sdpa"], runs["plain f64"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
