"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/repro_torch_kernels/lib<name>.so`` at
the repository root (git-ignored), then loaded with ctypes.  A library is
rebuilt when its source, or a shared header ``csrc/*.cuh``, is newer than
the built file.  Nothing is built when a module is imported: only a
launch on a CUDA tensor calls `load`.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "load", "build_all"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# -ldl: sm90.cuh takes cuTensorMapEncodeTiled from the loaded libcuda.so.1
# with dlopen, which glibc before 2.34 keeps in libdl
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-ldl")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()  # the ranks of a flow-sharded run are threads


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _compile(name: str) -> subprocess.Popen | None:
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    newest = max(f.stat().st_mtime for f in (src, *CSRC.glob("*.cuh")))
    if out.exists() and out.stat().st_mtime >= newest:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def build_all(names: Iterable[str] | None = None) -> Dict[str, str]:
    """Compile the named sources (default: every ``csrc/*.cu``) with one
    nvcc process each, all started together.  Returns each name's compiler
    output (ptxas register and shared-memory report); raises on failure."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    procs = {n: _compile(n) for n in names}
    logs = {}
    for n, p in procs.items():
        if p is None:
            logs[n] = "up to date"
            continue
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}.cu:\n{out}")
        logs[n] = out
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
            _LOADED[name] = lib
        return lib
