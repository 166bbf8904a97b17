"""Whack-a-Mole request router: the paper's engine at the serving layer.

R model replicas are the paths: replica shares live in a discrete profile
of m = 2**ell balls, each request picks its replica by the seeded
bit-reversal counter (the `spray_select` kernel, one row per batch), and
per-replica latency, error and queue feedback drives the §6 whack-down
controller.  The host arithmetic around the controller is the
reference's numpy (`repro.serve_router`); decisions and the controller
run on `device` (``"cuda"`` by default).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.feedback import ControllerState, PathStats, controller_step, make_controller
from repro_torch.core.profile import quantize_profile
from repro_torch.core.spray import SprayMethod, make_spray_state, spray_batch
from repro_torch.device import resolve_device

__all__ = ["Router", "RouterReport"]


@dataclasses.dataclass
class RouterReport:
    """Aggregated per-replica feedback for one reporting window."""

    latency_ms: np.ndarray   # mean observed latency per replica
    error_rate: np.ndarray   # failed / issued
    queue_depth: np.ndarray  # outstanding requests (ECN analogue)


class Router:
    """Deterministic request router over R replicas.

    >>> r = Router(replica_weights=[1, 1, 1, 1], device="cpu")
    >>> r.assign(batch_size=8).tolist()
    [2, 0, 3, 1, 2, 0, 3, 1]
    """

    def __init__(
        self,
        replica_weights: Sequence[float],
        *,
        ell: int = 10,
        seed: tuple = (333, 735),
        method: SprayMethod = SprayMethod.SHUFFLE_1,
        queue_ecn_threshold: float = 8.0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        profile = quantize_profile(np.asarray(replica_weights, float), ell,
                                   device=self.device)
        self._ctrl: ControllerState = make_controller(profile)
        m = 1 << ell
        self._spray = make_spray_state(profile, method=method,
                                       sa=seed[0] % m, sb=(seed[1] % m) | 1)
        self._qthresh = queue_ecn_threshold
        self.n = profile.n
        # the last batch's replica ids and per-replica sequence numbers (§5)
        self.last_ids: np.ndarray | None = None
        self.last_seqs: np.ndarray | None = None

    @property
    def shares(self) -> np.ndarray:
        b = self._ctrl.profile.b.cpu().numpy()
        return b / b.sum()

    def assign(self, batch_size: int) -> np.ndarray:
        """Replica id for each of `batch_size` requests (deterministic);
        ids and sequence numbers are also kept in ``last_ids``/``last_seqs``."""
        paths, seqs, self._spray = spray_batch(self._spray, self._ctrl.profile, batch_size)
        self.last_ids, self.last_seqs = paths.cpu().numpy(), seqs.cpu().numpy()
        return self.last_ids

    def report(self, rep: RouterReport) -> np.ndarray:
        """Feed one window of replica health; returns severity weights."""
        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        stats = PathStats(
            ecn_rate=f32(np.clip(rep.queue_depth / self._qthresh - 1.0, 0.0, 1.0)),
            loss_rate=f32(rep.error_rate),
            rtt=f32(rep.latency_ms),
        )
        self._ctrl, w = controller_step(self._ctrl, stats)
        return w.cpu().numpy()

    def simulate_window(
        self,
        batch_size: int,
        service_ms: np.ndarray,
        rng: Optional[np.random.Generator] = None,
    ) -> RouterReport:
        """Toy closed loop: issue a batch, model per-replica queueing with
        the given mean service times, return the observed report."""
        rng = rng or np.random.default_rng(0)
        ids = self.assign(batch_size)
        counts = np.bincount(ids, minlength=self.n).astype(float)
        # M/D/1-ish: latency grows with load x service time
        lat = service_ms * (1.0 + counts / max(batch_size / self.n, 1.0))
        return RouterReport(
            latency_ms=lat,
            error_rate=np.zeros(self.n),
            queue_depth=counts,
        )
