"""Deterministic synthetic data pipeline with O(1) skip-ahead: the port of
the JAX package's `data/pipeline.py`.

Every batch is a pure function of (seed, step, shard), drawn on the host
from numpy's Philox stream exactly as the reference draws it (so the two
packages see the same tokens bit for bit), so resuming after preemption
needs no data-state checkpoint.  `host_batch` moves a batch to the
device, on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["SyntheticLM", "host_batch"]


def _philox(seed: int, step: int, shard: int) -> np.random.Generator:
    """Counter-based stream: independent for every (seed, step, shard)."""
    return np.random.Generator(np.random.Philox(key=seed, counter=[step, shard, 0, 0]))


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Markov-ish synthetic token stream (a bigram chain, so loss curves
    mean something)."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1

    def shard_batch(self, step: int, shard: int) -> Dict[str, np.ndarray]:
        if self.global_batch % self.n_shards:
            raise ValueError(f"{self.global_batch} sequences do not split into "
                             f"{self.n_shards} shards")
        b = self.global_batch // self.n_shards
        rng = _philox(self.seed, step, shard)
        # bigram chain: x_{t+1} = (31 x_t + 17 + noise) mod V
        x0 = rng.integers(0, self.vocab_size, (b, 1))
        noise = rng.integers(0, 7, (b, self.seq_len - 1))
        toks = [x0]
        for t in range(self.seq_len - 1):
            toks.append((toks[-1] * 31 + 17 + noise[:, t:t + 1]) % self.vocab_size)
        return {"tokens": np.concatenate(toks, axis=1).astype(np.int32)}

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        shards = [self.shard_batch(step, s) for s in range(self.n_shards)]
        return {k: np.concatenate([s[k] for s in shards], axis=0) for k in shards[0]}


def host_batch(ds: SyntheticLM, step: int, extra: Optional[Dict[str, tuple]] = None, *,
               device="cuda") -> Dict[str, torch.Tensor]:
    """The batch of ``step`` as tensors on ``device`` (int32 tokens), with
    zero-filled modality stubs (patches, frames) where ``extra`` gives
    their (shape, torch dtype)."""
    dev = resolve_device(device)
    b = {k: torch.as_tensor(v, device=dev) for k, v in ds.batch(step).items()}
    for name, (shape, dtype) in (extra or {}).items():
        b[name] = torch.zeros(shape, dtype=dtype, device=dev)
    return b
