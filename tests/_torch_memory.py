"""What the port's tensors hold on the CPU, as the memory tests count it
(not a test module).

`LiveStorages` is a dispatch mode that follows every storage the ops run
under it make, with a weak reference, and keeps the most of those that a
predicate picks which were alive at once: a count of live tensors of a
kind (a recurrent block's matrix memories, an optimizer's leaf-sized
temporaries).  It counts the storages ops allocate: views and in-place
ops make none.  It sees the
backward's ops and a checkpoint's recomputations too.
"""
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class LiveStorages(TorchDispatchMode):
    """``peak``: the most storages of tensors that ``match`` alive at once
    among those the ops run under this mode make."""

    def __init__(self, match):
        super().__init__()
        self.match, self.live, self.peak = match, {}, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(r.alias_info is not None for r in func._schema.returns):
            return out  # a view or an in-place op: no new storage
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and self.match(t):
                ref = StorageWeakRef(t.untyped_storage())
                self.live[ref.cdata] = ref
                if len(self.live) > self.peak:  # a new peak only if none has died
                    self.live = {k: r for k, r in self.live.items() if not r.expired()}
                    self.peak = max(self.peak, len(self.live))
        return out
