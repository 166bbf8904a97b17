"""Architecture registry: ``--arch <id>`` resolution and smoke variants.

Every id of the JAX package's registry resolves to its config here, and
every sublayer kind, FFN and frontend of those configs is ported: each
arch's model builds, serves and trains.  The configs also feed the cost
model and the job layer.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "all_configs"]

ARCH_IDS = [
    "arctic-480b",
    "dbrx-132b",
    "jamba-v0.1-52b",
    "starcoder2-3b",
    "qwen3-8b",
    "qwen1.5-4b",
    "h2o-danube-3-4b",
    "xlstm-350m",
    "llava-next-mistral-7b",
    "whisper-large-v3",
]

_MODULES = {
    "arctic-480b": "arctic_480b",
    "dbrx-132b": "dbrx_132b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-8b": "qwen3_8b",
    "qwen1.5-4b": "qwen1_5_4b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "xlstm-350m": "xlstm_350m",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "whisper-large-v3": "whisper_large_v3",
}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).smoke()


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
