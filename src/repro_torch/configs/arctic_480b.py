"""snowflake-arctic-base: 480B hybrid dense+MoE.

35L d_model=7168 56H (GQA kv=8) dense d_ff=4864 residual branch in parallel
with a 128-expert top-2 MoE, vocab 32000.  [hf:Snowflake/snowflake-arctic-base]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    period=(LayerSpec("attn", "moe"),),
    moe_experts=128,
    moe_top_k=2,
    moe_dense_ff=4864,      # dense residual branch in parallel with the MoE
    mlp_kind="swiglu",
    rope_theta=1e6,
    param_dtype="bfloat16",  # 480B: bf16 params + adafactor (v5e HBM budget)
    optimizer="adafactor",
    source="hf:Snowflake/snowflake-arctic-base; hf",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        moe_dense_ff=96,
        moe_experts=8,
        moe_top_k=2,
        vocab_size=256,
        param_dtype="float32",
    )
