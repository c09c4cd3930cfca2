"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. It is
compiled at first use for Hopper (``sm_90a``) into ``build/`` inside the
package (listed in ``.gitignore``), under a name that carries a hash of the
source, so an edited source never loads a stale library. Nothing here runs
at import time: the CPU tests import every module on machines without
``nvcc``.
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
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile time in this process; 0.0 when reused
    log: str  # nvcc/ptxas output (registers, shared memory, spills)


_LOCK = threading.Lock()
_LOADED: Dict[str, BuiltLibrary] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels of indoor_nerf_tpu_torch are built from csrc/ at first use")


def load_library(name: str) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` (once per source version) and load it."""
    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
        src = CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        seconds, log = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                   "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {src}:\n{log}")
            os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
        built = BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)
        _LOADED[name] = built
        return built
