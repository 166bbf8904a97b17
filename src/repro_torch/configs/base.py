"""Architecture configs and input-shape registry (a copy of the JAX
package's `configs/base.py`: the port imports nothing of it).

Every assigned architecture is an `ArchConfig` (exact published dims) plus a
`smoke()` reduced variant for CPU tests.  Layer stacks are described by a
*period spec*: the repeating pattern of sublayer kinds (attention / mamba /
mlstm / slstm) and whether each carries an MoE or dense FFN — this is what
lets heterogeneous stacks (Jamba's 1:7 attn:mamba, xLSTM's mLSTM/sLSTM
alternation) run as one loop over stacked periods.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig", "LayerSpec", "ShapeSpec", "SHAPES", "shape_by_name"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One sublayer in the repeating period."""

    kind: str          # "attn" | "mamba" | "mlstm" | "slstm"
    ffn: str = "mlp"   # "mlp" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int                  # total sublayers (periods * len(period))
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    period: Tuple[LayerSpec, ...]  # repeating stack pattern
    d_head: int = 0                # 0 -> d_model // n_heads
    # attention
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    window: Optional[int] = None   # sliding-window size (None = full)
    # ffn
    mlp_kind: str = "swiglu"       # swiglu | gelu
    # moe
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_dense_ff: int = 0          # arctic: parallel dense residual branch
    capacity_factor: float = 1.25
    # ssm (mamba)
    ssm_d_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0           # 0 -> ceil(d_model / 16)
    # xlstm
    xlstm_proj_factor: float = 2.0
    # enc-dec (whisper)
    encoder_layers: int = 0
    # modality stubs
    prefix_tokens: int = 0         # vlm: image-patch embedding prefix length
    frontend: Optional[str] = None # "audio_frames" | "vision_patches"
    # serving
    kv_quant: bool = False         # int8 KV cache (per-entry scales)
    # numerics / training
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "float32"   # bf16 for the >100B MoEs (adafactor)
    optimizer: str = "adamw"
    # notes
    source: str = ""

    def __post_init__(self):
        if self.n_layers % len(self.period) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"period length {len(self.period)}"
            )

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def subquadratic(self) -> bool:
        """Can decode at 500k context with bounded state? True when every
        attention is windowed or the stack is attention-light (SSM/hybrid)."""
        kinds = {s.kind for s in self.period}
        if "attn" not in kinds:
            return True
        return self.window is not None or self.family in ("hybrid", "ssm")

    @property
    def attn_layer_count(self) -> int:
        per = sum(1 for s in self.period if s.kind == "attn")
        total = per * self.n_periods
        return total


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_by_name(name: str) -> ShapeSpec:
    return SHAPES[name]
