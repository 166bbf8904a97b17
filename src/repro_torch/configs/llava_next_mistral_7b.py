"""llava-hf/llava-v1.6-mistral-7b: VLM on a Mistral-7B backbone.

32L d_model=4096 32H (GQA kv=8) d_ff=14336, vocab 32000.  The anyres vision
tower is a STUB per the brief: input_specs supplies pre-computed patch
embeddings (prefix_tokens of the sequence budget); a learned 2-layer MLP
projector (the real llava projector) maps them into the backbone.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    period=(LayerSpec("attn", "mlp"),),
    mlp_kind="swiglu",
    rope_theta=1e6,        # v0.2 base: 32k context, full attention
    prefix_tokens=2048,    # anyres patch budget within the seq length
    frontend="vision_patches",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
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
        prefix_tokens=8,
    )
