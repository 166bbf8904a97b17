"""LT fountain code: the erasure transport the paper sprays for (§1-2).

A message of K source symbols becomes a stream of encoded symbols, each
the XOR of d source symbols with d drawn from the robust soliton.  Any
~K(1+eps) received symbols decode with high probability by peeling.

Degree and neighbour sampling and the peeling decoder are host numpy, as
in the reference (`repro.net.fountain`), and draw the same numbers from
the same `np.random.Generator`.  Encoding runs the `lt_encode` kernel on
the card (``device="cuda"``, the default) or its plain version on the CPU.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.lt_encode import as_int32_bits, as_uint32, lt_encode

__all__ = ["robust_soliton", "sample_encoding", "encode", "peel_decode",
           "decode_overhead_curve", "as_uint32"]


def robust_soliton(K: int, c: float = 0.05, delta: float = 0.05) -> np.ndarray:
    """Robust-soliton degree distribution over degrees 1..K."""
    d = np.arange(1, K + 1, dtype=np.float64)
    rho = np.zeros(K)
    rho[0] = 1.0 / K
    rho[1:] = 1.0 / (d[1:] * (d[1:] - 1.0))
    R = c * np.log(K / delta) * np.sqrt(K)
    tau = np.zeros(K)
    pivot = int(np.floor(K / R)) if R > 0 else K
    pivot = max(1, min(pivot, K))
    idx = np.arange(1, pivot)
    tau[idx - 1] = R / (idx * K)
    tau[pivot - 1] = R * np.log(R / delta) / K if R > 0 else 0.0
    mu = rho + np.maximum(tau, 0.0)
    return mu / mu.sum()


def sample_encoding(
    K: int, R: int, rng: np.random.Generator, dmax: int = 32,
    c: float = 0.05, delta: float = 0.05,
) -> Tuple[np.ndarray, np.ndarray]:
    """(neighbors int32[R, dmax], valid bool[R, dmax]) for R encoded symbols.
    Degrees are drawn from the soliton cut to 1..dmax and renormalised."""
    probs = robust_soliton(K, c, delta)
    probs = probs[:dmax] / probs[:dmax].sum()
    degrees = rng.choice(np.arange(1, dmax + 1), size=R, p=probs)
    neighbors = np.zeros((R, dmax), dtype=np.int32)
    valid = np.zeros((R, dmax), dtype=bool)
    for r in range(R):
        d = int(degrees[r])
        neighbors[r, :d] = rng.choice(K, size=d, replace=False)
        valid[r, :d] = True
    return neighbors, valid


def encode(payload, neighbors, valid, *, device="cuda") -> torch.Tensor:
    """Encoded symbols int32[R, P] (uint32 bit patterns) on `device`.

    ``payload`` is a uint32 numpy array or an int32 tensor of bit
    patterns; ``neighbors`` and ``valid`` numpy arrays or tensors.
    `as_uint32` turns the result into the reference's uint32 array."""
    dev = resolve_device(device)
    return lt_encode(as_int32_bits(payload).to(dev), torch.as_tensor(neighbors).to(dev),
                     torch.as_tensor(valid).to(dev))


def peel_decode(
    encoded: np.ndarray,    # uint32[R, P] received symbols
    neighbors: np.ndarray,  # int32[R, dmax]
    valid: np.ndarray,      # bool[R, dmax]
    K: int,
) -> np.ndarray | None:
    """Belief-propagation peeling decoder.  Returns uint32[K, P] or None if
    the received set is insufficient.

    The reference's order is kept (a LIFO ripple; the equations holding a
    decoded symbol are reduced in ascending order), so the output equals
    the reference's even on inconsistent input.  A symbol -> equations
    index replaces the reference's scan over all R equations."""
    R, P = encoded.shape
    eqs = [set(neighbors[r, valid[r]].tolist()) for r in range(R)]
    vals = [encoded[r].copy() for r in range(R)]
    holders: dict = {}
    for r in range(R):
        for s in eqs[r]:
            holders.setdefault(s, []).append(r)
    decoded = np.zeros((K, P), dtype=np.uint32)
    known = np.zeros(K, dtype=bool)
    ripple = [r for r in range(R) if len(eqs[r]) == 1]
    while ripple:
        r = ripple.pop()
        if not eqs[r]:
            continue
        (s,) = tuple(eqs[r])
        if known[s]:
            eqs[r].clear()
            continue
        decoded[s] = vals[r]
        known[s] = True
        eqs[r].clear()
        for r2 in holders[s]:
            if s in eqs[r2]:
                eqs[r2].discard(s)
                vals[r2] ^= decoded[s]
                if len(eqs[r2]) == 1:
                    ripple.append(r2)
    return decoded if known.all() else None


def decode_overhead_curve(
    K: int, trials: int, rng: np.random.Generator, dmax: int = 32, *,
    device="cuda",
) -> np.ndarray:
    """For each trial: the least number of received symbols that decoded
    (bisection over prefixes of a fresh encoded stream).

    As in the reference, a trial whose whole stream of R = int(1.6K) + 32
    symbols does not decode reports R."""
    dev = resolve_device(device)
    out = np.zeros(trials, dtype=np.int64)
    payload = rng.integers(0, 2**32, (K, 8), dtype=np.uint32)
    for t in range(trials):
        R = int(K * 1.6) + 32
        neigh, valid = sample_encoding(K, R, rng, dmax=dmax)
        enc = as_uint32(encode(payload, neigh, valid, device=dev))
        lo, hi = K, R
        while lo < hi:
            mid = (lo + hi) // 2
            ok = peel_decode(enc[:mid], neigh[:mid], valid[:mid], K) is not None
            if ok:
                hi = mid
            else:
                lo = mid + 1
        out[t] = lo
    return out
