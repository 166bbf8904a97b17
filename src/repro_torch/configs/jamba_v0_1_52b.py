"""ai21labs Jamba-v0.1: 52B Mamba+attention hybrid MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336, attn:mamba 1:7 (one attention
layer per 8), MoE 16e top-2 on every second layer, vocab 65536.
[arXiv:2403.19887]

Period = 8 sublayers (indices 0..7): attention at index 4 (as in the paper's
block layout), MoE on odd indices, dense MLP on even ones.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, LayerSpec


def _period():
    subs = []
    for i in range(8):
        kind = "attn" if i == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "mlp"
        subs.append(LayerSpec(kind, ffn))
    return tuple(subs)


CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    period=_period(),
    moe_experts=16,
    moe_top_k=2,
    mlp_kind="swiglu",
    ssm_d_state=16,
    ssm_conv=4,
    ssm_expand=2,
    param_dtype="bfloat16",
    optimizer="adafactor",
    source="arXiv:2403.19887; hf",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=8,          # one full period
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        moe_experts=4,
        moe_top_k=2,
        vocab_size=256,
        ssm_d_state=8,
        param_dtype="float32",
    )
