"""bigcode/starcoder2-3b: dense code LM.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 (non-gated GeLU), vocab 49152,
RoPE, sliding window 4096.  [arXiv:2402.19173]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    period=(LayerSpec("attn", "mlp"),),
    mlp_kind="gelu",
    window=4096,          # SWA => long_500k runs with a ring-buffer cache
    rope_theta=1e5,
    qkv_bias=True,
    source="arXiv:2402.19173; hf",
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
        window=32,
    )
