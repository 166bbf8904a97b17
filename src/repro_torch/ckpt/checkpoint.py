"""Fault-tolerant checkpointing: atomic, async, in the JAX package's format.

The port of `repro/ckpt/checkpoint.py`, writing and reading the same
files, so that each package restores the other's checkpoint of the same
state:

    <dir>/step_<N>/arrays.npz + manifest.json  (+ <dir>/LATEST)

* Keys are the reference's ``_path_str`` of the same tree (`tree.paths`:
  ``.params/layers/sub0/...``, ``.opt_state/.m/...``, ``.step``).
* bf16 arrays are stored as their uint16 bits (numpy has no bf16); the
  manifest keeps the dtype name and the SHA1 of every array's bytes,
  which `restore` verifies.
* Atomic: a step is written to a temporary directory, fsync'd and renamed
  into place, and LATEST is replaced last, so a crash mid-save leaves the
  previous checkpoint intact.
* Async: `save_async` copies the tree to host memory, then writes it in a
  thread, so the train loop goes on (the caller joins the thread before
  the next save).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T

__all__ = ["save", "save_async", "restore", "latest_step", "gc_checkpoints"]

_TORCH = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int8": torch.int8, "int16": torch.int16,
          "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _TORCH.items()}


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(a host copy in a dtype numpy stores, the leaf's dtype name)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), _NAMES[t.dtype]
    a = np.array(leaf)
    if a.dtype.kind in "biufc":
        return a, str(a.dtype)
    return a.view(f"u{a.dtype.itemsize}"), str(a.dtype)  # e.g. ml_dtypes' bfloat16


def _flatten(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {k: _host(v) for k, v in T.paths(tree)}


def _write(flat: Dict[str, Tuple[np.ndarray, str]], ckpt_dir: str, step: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {
        "step": step,
        "arrays": {k: {"shape": list(a.shape), "dtype": name,
                       "sha1": hashlib.sha1(a.tobytes()).hexdigest()}
                   for k, (a, name) in flat.items()},
    }
    np.savez(os.path.join(tmp, "arrays.npz"), **{k: a for k, (a, _) in flat.items()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    latest = os.path.join(ckpt_dir, "LATEST")
    with open(latest + ".tmp", "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest + ".tmp", latest)
    return final


def save(tree: Any, ckpt_dir: str, step: int) -> str:
    """Blocking atomic save of a tree of tensors (or numpy arrays).
    Returns the checkpoint's path."""
    return _write(_flatten(tree), ckpt_dir, step)


def save_async(tree: Any, ckpt_dir: str, step: int) -> threading.Thread:
    """Copy to host memory now, write in a background thread (started and
    returned; join it before relying on the files)."""
    t = threading.Thread(target=_write, args=(_flatten(tree), ckpt_dir, step))
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None, *, verify: bool = True):
    """Load into the structure of ``template`` (a tree of tensors; only
    their devices are read): each leaf comes back in the manifest's dtype
    and shape, on its template leaf's device (the reference re-places a
    checkpoint under any sharding the same way).  ``step`` defaults to
    LATEST; with ``verify`` every array's SHA1 is checked against the
    manifest."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    loaded = []
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for key, tmpl in T.paths(template):
            arr = data[key]
            meta = manifest["arrays"][key]
            if verify and hashlib.sha1(arr.tobytes()).hexdigest() != meta["sha1"]:
                raise IOError(f"checksum mismatch for {key} in step {step}")
            want = _TORCH[meta["dtype"]]
            if want == torch.bfloat16:
                t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            if list(t.shape) != meta["shape"]:
                raise IOError(f"{key}: shape {list(t.shape)}, manifest {meta['shape']}")
            loaded.append(t.to(tmpl.device))
    it = iter(loaded)
    return T.map_leaves(lambda _: next(it), template)


def gc_checkpoints(ckpt_dir: str, keep_last: int = 3) -> None:
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
                   if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"))
