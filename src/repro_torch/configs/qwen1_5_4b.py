"""Qwen/Qwen1.5-4B: dense with QKV bias.

40L d_model=2560 20H (GQA kv=20 = MHA) d_ff=6912, vocab 151936, QKV bias.
[hf:Qwen/Qwen1.5-0.5B family]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    period=(LayerSpec("attn", "mlp"),),
    mlp_kind="swiglu",
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
    )
