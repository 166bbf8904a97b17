"""databricks/dbrx-base: 132B fine-grained MoE.

40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert, MoE 16e top-4,
vocab 100352.  [hf:databricks/dbrx-base]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    period=(LayerSpec("attn", "moe"),),
    moe_experts=16,
    moe_top_k=4,
    mlp_kind="swiglu",
    rope_theta=5e5,
    param_dtype="bfloat16",
    optimizer="adafactor",
    source="hf:databricks/dbrx-base; unverified",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        moe_experts=4,
        moe_top_k=2,
        vocab_size=256,
        param_dtype="float32",
    )
