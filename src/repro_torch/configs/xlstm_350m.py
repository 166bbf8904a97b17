"""xLSTM-350m: sLSTM + mLSTM recurrent LM (attention-free).

24 blocks d_model=1024 4H, vocab 50304, d_ff=0 (the blocks carry their own
projections: mLSTM PF=2, sLSTM gated FFN 4/3).  1:1 mLSTM/sLSTM interleave.
[arXiv:2405.04517]
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    period=(LayerSpec("mlstm", "none"), LayerSpec("slstm", "none")),
    xlstm_proj_factor=2.0,
    source="arXiv:2405.04517; unverified",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        vocab_size=256,
    )
