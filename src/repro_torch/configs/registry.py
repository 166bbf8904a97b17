"""Architecture registry: ``--arch <id>`` resolution and smoke variants.

Every id of the JAX package's registry is known here; the ids whose
model is not ported yet raise `NotImplementedError`.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

__all__ = ["ARCH_IDS", "PORTED", "get_config", "get_smoke_config"]

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

# ported id -> module under repro_torch.configs
PORTED = {
    "qwen3-8b": "qwen3_8b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
}


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet (ROADMAP queue 1, item 11: the rest of "
            f"the model zoo); ported: {sorted(PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{PORTED[arch_id]}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).smoke()
