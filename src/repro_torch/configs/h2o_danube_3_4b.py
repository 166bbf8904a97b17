"""h2oai/h2o-danube3-4b: llama/mistral-mix dense with sliding window.

24L d_model=3840 32H (GQA kv=8) d_ff=10240, vocab 32000, SWA.
[arXiv:2401.16818 family]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    period=(LayerSpec("attn", "mlp"),),
    mlp_kind="swiglu",
    window=4096,          # mistral-style SWA => long_500k runs
    rope_theta=1e4,
    source="arXiv:2401.16818; unverified",
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
