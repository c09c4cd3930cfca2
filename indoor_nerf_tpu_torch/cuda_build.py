"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface; the
headers beside it (``csrc/*.cuh``) hold code that kernels share. A kernel
is compiled at first use for Hopper (``sm_90a``) into ``build/`` inside the
package (listed in ``.gitignore``), under a name that carries a hash of its
source and of every header in ``csrc/``, so an edited source or header
never loads a stale library. Nothing here runs at import time: the CPU
tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

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


_LOCK = threading.Lock()  # guards _LOADED
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


def source_digest(name: str, csrc_dir: Path = CSRC_DIR) -> str:
    """Hash of ``<name>.cu`` and every ``*.cuh`` beside it (names and bytes)."""
    h = hashlib.sha256()
    for path in [csrc_dir / f"{name}.cu", *sorted(csrc_dir.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0")
        h.update(path.read_bytes())
        h.update(b"\0")
    return h.hexdigest()[:16]


def _compile(name: str) -> Tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless this source version is built.

    Returns (library path, compile seconds, nvcc log). Safe to run
    concurrently: the library appears by an atomic rename."""
    src = CSRC_DIR / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{source_digest(name)}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {src}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return out, seconds, log


def load_library(name: str) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` (once per source version) and load it."""
    with _LOCK:
        if name not in _LOADED:
            out, seconds, log = _compile(name)
            _LOADED[name] = BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)
        return _LOADED[name]


def launch_on_stream(fn: Callable, error_string: Callable, what: str,
                     tensors: Sequence[Tuple[str, object]], *args,
                     align: int = 1, device=None) -> None:
    """Call the C launcher ``fn(*pointers, *args, stream)`` on PyTorch's
    current stream of the tensors' device (a CUDA device), or raise. Every
    kernel of the package is launched here.

    ``tensors`` are (name, tensor) in the C argument order; each must lie on
    that one device, contiguous, at an address that is a multiple of
    ``align`` bytes (16 for the kernels that move float4s). ``fn`` returns
    ``cudaGetLastError()``: a refused launch raises here, with
    ``error_string(code)`` naming it. ``device`` names the device where
    the launcher takes no tensor (its pointers come in ``args``)."""
    import torch

    if device is None:
        device = tensors[0][1].device
    for name, t in tensors:
        if t.device != device or not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{name} must be on {device} and contiguous"
                             + (f", at a multiple of {align} bytes"
                                if align > 1 else ""))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*(t.data_ptr() for _, t in tensors), *args, stream)
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{error_string(code).decode()} ({code})")


def build_all(names: Sequence[str]) -> Dict[str, BuiltLibrary]:
    """Build several kernels at once, one ``nvcc`` per source, all started
    together, then load each. Raises the first build failure."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        compiled = dict(zip(names, pool.map(_compile, names)))
    with _LOCK:
        for name, (out, seconds, log) in compiled.items():
            if name not in _LOADED:
                _LOADED[name] = BuiltLibrary(ctypes.CDLL(str(out)), out,
                                             seconds, log)
        return {name: _LOADED[name] for name in names}
