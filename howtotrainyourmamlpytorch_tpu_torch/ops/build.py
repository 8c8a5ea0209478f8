"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``_build/`` (listed in ``.gitignore``) at first use, and loaded with
``ctypes``. The library's file name carries a hash of the source, so an
edited kernel rebuilds and a stale library is never loaded. Nothing is
built when a module is imported: only a kernel launch asks for its
library. That first launch falls inside a train step, so a cold build
runs under the watchdog's ``compile`` phase (its budget,
``watchdog_compile_timeout_s``, not the step's); a cached load does not.

The kernel build cache (``compilation_cache_dir``, :func:`set_cache_dir`):
with a directory set, libraries are built into and loaded from it
instead of ``_build/``, under the same source-hash names, so a fresh
process, or another rank on a shared directory, loads the library with
no ``nvcc`` run. ``nvcc_runs`` counts, per process, the libraries
built (a library found on disk is loaded with none).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

from howtotrainyourmamlpytorch_tpu_torch.resilience import watchdog

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Built:
    """A loaded kernel library and how it was built."""
    lib: ctypes.CDLL
    path: str
    seconds: float   # nvcc wall time; 0.0 when the library was on disk
    log: str         # nvcc's output (ptxas registers / spills per kernel)


_built: Dict[str, Built] = {}
_lock = threading.Lock()
# compilation_cache_dir when set (None: BUILD_DIR), and the per-process
# count of libraries built by nvcc.
_cache_dir: Optional[str] = None
nvcc_runs = 0


def set_cache_dir(path: Optional[str]) -> Optional[str]:
    """Build into and load from ``path`` (``None``: ``_build/``); returns
    the previous directory. Libraries already loaded in this process
    stay loaded: their names carry their source's hash either way."""
    global _cache_dir
    with _lock:
        prev = _cache_dir
        _cache_dir = os.path.abspath(path) if path else None
        return prev


def cache_dir() -> str:
    """Where :func:`load` builds and looks for libraries."""
    return _cache_dir or BUILD_DIR


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from csrc/ at first use on a machine with the CUDA "
        "toolkit")


def load(name: str) -> Built:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    global nvcc_runs
    with _lock:
        if name in _built:
            return _built[name]
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        directory = cache_dir()
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"lib{name}-{digest}.so")
        seconds, log = 0.0, ""
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            t0 = time.perf_counter()
            with watchdog.phase("compile", detail=f"nvcc:{name}"):
                proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {src}:\n{log}")
            os.replace(tmp, path)  # atomic: concurrent builds agree
            nvcc_runs += 1
        built = Built(lib=ctypes.CDLL(path), path=path, seconds=seconds,
                      log=log)
        _built[name] = built
        return built
