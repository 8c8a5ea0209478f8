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
from typing import Dict

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
    with _lock:
        if name in _built:
            return _built[name]
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
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
        built = Built(lib=ctypes.CDLL(path), path=path, seconds=seconds,
                      log=log)
        _built[name] = built
        return built
