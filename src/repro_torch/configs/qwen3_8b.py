"""Qwen/Qwen3-8B: dense with qk-norm.

36L d_model=4096 32H (GQA kv=8) d_ff=12288, vocab 151936, qk_norm.
[hf:Qwen/Qwen3-8B]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    period=(LayerSpec("attn", "mlp"),),
    mlp_kind="swiglu",
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B; hf",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
    )
