"""Ranks as threads of the calling process, each with a private
`torch.distributed` group.

The flow-sharded engines (`net.sender.shard_run_flows` and the job and
cluster runners over it) split the flow axis into contiguous blocks, one
per rank of a `Mesh`.  `run_ranks` runs one thread per rank and hands each
a `RankComm`: a process group of its own over an in-process store
(`HashStore`), so a call needs no `init_process_group`, sets no
environment variable, spawns no subprocess and leaves no default group
behind.

* Ranks that share a device, or run on the CPU, use gloo over the
  loopback address; a CUDA tensor is staged through host memory.  Ranks
  that each have a card of their own use NCCL (it refuses two ranks on one
  device).
* The ranks of one card run on its default stream, so a tensor one rank
  makes never meets another stream.
* The ranks take turns on the host: a rank holds the call's baton (a
  lock) while it runs and hands it on only while it waits in a
  collective.  Threads that ran together would contend for the
  interpreter lock at every tensor operation, which costs more than the
  turns do.
* Every group has a timeout, and so has every wait for a thread or a
  turn: an exception in any rank reaches the caller.  A failing rank
  aborts its group (with NCCL, every rank's), so the others' collectives
  fail at once instead of waiting out the timeout.
"""
from __future__ import annotations

import dataclasses
import datetime
import threading
import time
from typing import Callable, List, Tuple

import torch
import torch.distributed as dist

__all__ = ["DEFAULT_TIMEOUT", "Mesh", "RankComm", "run_ranks"]

# seconds a collective waits for the other ranks (the first call on the
# card may build a kernel with nvcc before its first collective)
DEFAULT_TIMEOUT = 600.0
_POLL = 0.05  # seconds between checks of the rank threads


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a flow-sharded run: rank r runs on ``devices[r]``."""

    devices: Tuple[torch.device, ...]
    timeout: float = DEFAULT_TIMEOUT

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one rank")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"a mesh's ranks run on one kind of device, got {self.devices}")
        if self.timeout <= 0:
            raise ValueError(f"timeout must be positive, got {self.timeout}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def backend(self) -> str:
        """NCCL when every rank has a card of its own, else gloo."""
        cards = [d for d in self.devices if d.type == "cuda"]
        return "nccl" if len(cards) == self.size and len(set(cards)) == self.size else "gloo"


class RankComm:
    """One rank's collectives over its private group."""

    def __init__(self, mesh: Mesh, rank: int, store, baton: threading.Lock):
        self.rank, self.size, self.device = rank, mesh.size, mesh.devices[rank]
        self._baton, self.has_baton, self._timeout = baton, False, mesh.timeout
        timeout = datetime.timedelta(seconds=mesh.timeout)
        store = dist.PrefixStore(f"{mesh.backend}/", store)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # the rank's thread launches there
        if mesh.backend == "nccl":
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            self._group = dist.ProcessGroupNCCL(store, rank, self.size, opts)
        else:
            opts = dist.ProcessGroupGloo._Options()
            opts._timeout = timeout
            opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
            self._group = dist.ProcessGroupGloo(store, rank, self.size, opts)
        self._nccl = mesh.backend == "nccl"
        self._staged = not self._nccl and self.device.type == "cuda"

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        src = x.cpu() if self._staged else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        self._collective(lambda: self._group.allgather([parts], [src]))
        out = torch.cat(parts, dim)
        return out.to(self.device) if self._staged else out

    def all_true(self, pred: torch.Tensor) -> bool:
        """Whether ``pred`` (a bool scalar) holds on every rank."""
        t = pred.to(torch.int32).reshape(1)
        t = t.cpu() if self._staged else t
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.MIN
        self._collective(lambda: self._group.allreduce([t], opts))
        return bool(t)

    def take_baton(self) -> None:
        """Wait for this rank's turn, as long as a collective may wait."""
        if not self._baton.acquire(timeout=self._timeout):
            raise TimeoutError(f"flow rank {self.rank} waited {self._timeout} s for its turn: "
                               "another rank runs without reaching its collective")
        self.has_baton = True

    def _collective(self, start: Callable) -> None:
        """Start a collective and wait for its result with the baton handed
        on (NCCL connects at its first collective and finishes one on the
        card, so its rank waits there too); a rank whose collective failed
        leaves without taking the baton back, so a rank that holds it, hung,
        keeps no one from reporting."""
        self._baton.release()
        self.has_baton = False
        start().wait()
        if self._nccl:
            torch.cuda.current_stream(self.device).synchronize()
        self.take_baton()

    def close(self, *, abort: bool = False) -> None:
        """Shut the group down (``abort``: at once, from any thread, ending
        the collectives its rank waits in)."""
        group, self._group = self._group, None
        for name in ("abort",) if abort else ("shutdown", "abort"):
            stop = getattr(group, name, None)
            if stop is not None and group is not None:
                stop()
                break


def run_ranks(mesh: Mesh, body: Callable[[RankComm], object]) -> List[object]:
    """``[body(comm) for each rank]``, each rank on a thread of its own.

    The first exception any rank raised is raised here, with a note of its
    rank; once a rank has failed the others get ``mesh.timeout`` seconds to
    end before a `TimeoutError` is raised instead."""
    for dev in dict.fromkeys(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    store = dist.HashStore()
    results: List[object] = [None] * mesh.size
    failures: List[Tuple[int, BaseException]] = []
    comms: List[RankComm | None] = [None] * mesh.size
    lock, baton = threading.Lock(), threading.Lock()

    def work(rank: int) -> None:
        try:
            comms[rank] = RankComm(mesh, rank, store, baton)
            comms[rank].take_baton()
            results[rank] = body(comms[rank])
            if mesh.devices[rank].type == "cuda":
                torch.cuda.synchronize(mesh.devices[rank])
        except BaseException as exc:  # noqa: BLE001 - handed to the caller
            with lock:
                failures.append((rank, exc))
                # a closed gloo group fails its peers' waits at once; an NCCL
                # rank waits on its card until its own group is aborted
                stop = comms if mesh.backend == "nccl" else [comms[rank]]
                for comm in stop:
                    if comm is not None:
                        comm.close(abort=True)
        finally:
            if comms[rank] is not None and comms[rank].has_baton:
                baton.release()
            with lock:
                if comms[rank] is not None:
                    comms[rank].close()

    threads = [threading.Thread(target=work, args=(r,), name=f"flow-rank-{r}", daemon=True)
               for r in range(mesh.size)]
    for t in threads:
        t.start()
    deadline = None
    for t in threads:
        while t.is_alive():
            t.join(_POLL)
            if failures and deadline is None:
                deadline = time.monotonic() + mesh.timeout
            if deadline is not None and time.monotonic() > deadline and t.is_alive():
                rank, exc = failures[0]
                raise TimeoutError(f"{t.name} still runs {mesh.timeout} s after rank {rank} "
                                   "failed") from exc
    if failures:
        rank, exc = failures[0]
        exc.add_note(f"raised in flow rank {rank} of {mesh.size}")
        raise exc
    return results
