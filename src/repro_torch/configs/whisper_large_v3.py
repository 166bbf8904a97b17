"""openai/whisper-large-v3 BACKBONE: encoder-decoder audio transformer.

32 decoder layers (self-attn + cross-attn + MLP) + 32 encoder layers,
d_model=1280 20H (kv=20) d_ff=5120, vocab 51866.  The conv/mel frontend is a
STUB: input_specs supplies frame embeddings [B, S, d_model].  Positional
signal is fixed sinusoidal on both sides (the learned-table variant differs
only by a lookup).  [arXiv:2212.04356]

n_layers counts SUBLAYER GROUPS: each decoder layer is a 2-sublayer period
(self-attn, cross-attn+mlp), so n_layers=64 <=> 32 published decoder layers.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=64,           # 32 decoder layers x 2 sublayers (attn | xattn+mlp)
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    period=(LayerSpec("attn", "none"), LayerSpec("xattn", "mlp")),
    mlp_kind="gelu",
    encoder_layers=32,
    frontend="audio_frames",
    source="arXiv:2212.04356; unverified",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        encoder_layers=2,
    )
