"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface; the
headers beside it (``csrc/*.cuh``) hold code that kernels share. A kernel
is compiled at first use for Hopper (``sm_90a``) into ``build/`` inside the
package (listed in ``.gitignore``), under a name that carries a hash of its
source and of every header in ``csrc/``, so an edited source or header
never loads a stale library. Nothing here runs at import time: the CPU
tests import every module on machines without ``nvcc``.

``SIGNATURES`` declares every C function of every library, so a loaded
library is ready to call; ``launch_on_stream`` launches every kernel and
counts each launch under its name (``launch_counts``, ``reset_counts``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

# The ``extern "C"`` functions of each ``csrc/<name>.cu``: argument kinds,
# then the return kind. ``ptr`` is ``void*`` (the tensors' addresses, the
# stream, host arrays the launcher reads), ``i32`` ``int``, ``i64`` ``long
# long``, ``i32*`` and ``u32*`` host arrays of ``int`` and ``unsigned int``.
# Every library also has ``<name>_error_string(int) -> const char*``, which
# ``load_library`` declares without an entry here.
SIGNATURES: Dict[str, Dict[str, str]] = {
    "tent_contract": {
        "tent_contract_f32": "ptr ptr ptr ptr i64 i32 i32 i32 i64 ptr -> i32",
        "tent_contract_bf16": "ptr ptr ptr ptr i64 i32 i32 i32 i64 ptr -> i32",
        "tent_pack_rows_f32": "ptr ptr i64 i32 i32 ptr -> i32",
        "tent_pack_rows_bf16": "ptr ptr i64 i32 i32 ptr -> i32",
        "tent_pack_rows_int8": "ptr ptr ptr i64 i32 i32 i64 ptr -> i32",
    },
    "table_scatter": {
        "table_scatter": "ptr ptr ptr ptr i64 i32 i32 i32 i64 i32 ptr -> i32",
        "table_scatter_unpack": "ptr ptr i64 i32 i32 ptr -> i32",
    },
    "group_scatter": {
        "group_scatter": "ptr ptr ptr ptr i64 i32 i32 i32 i32 i32 i64 i32* "
                         "i32 ptr -> i32",
        "group_scatter_anchored": "ptr ptr ptr ptr ptr i64 i32 i32 i32 i32 "
                                  "i32 i64 i32* i32 u32* i32 ptr -> i32",
        "group_anchor_coords": "ptr ptr ptr ptr ptr i64 i32 i32 i32 i32* i32 "
                               "u32* ptr -> i32",
    },
    "tile_interp": {
        "tile_interp_fwd": "ptr ptr ptr i64 ptr -> i32",
        "tile_interp_bwd_rows": "ptr ptr ptr i64 ptr -> i32",
    },
    "lane_gather": {
        "lane_select_fwd": "ptr ptr ptr i64 i32 ptr -> i32",
        "lane_select_grad": "ptr ptr ptr i64 i32 ptr -> i32",
    },
    "fused_radam": {
        "fused_radam_chunk": "-> i32",
        "fused_radam_max_leaves": "-> i32",
        "fused_radam": "ptr ptr ptr ptr ptr ptr i32 ptr -> i32",
    },
    "nerf_small_fused": {
        "nerf_small_fused_layout": "i32 i32 i32 i32* i32 -> i32",
        "nerf_small_fused_blocks_per_sm": "i32 i32 i32 -> i32",
        "nerf_small_fused": "ptr ptr ptr ptr ptr i64 i32 i32 i32 i32 ptr -> i32",
    },
    "occ_sample": {
        "occ_sample_max_candidates": "-> i32",
        "occ_sample_max_samples": "-> i32",
        "occ_sample": "ptr ptr ptr ptr ptr ptr ptr ptr i64 i32 i32 i32 i32 "
                      "i32 i32 i32 ptr i32* ptr -> i32",
    },
}
KINDS = {"ptr": ctypes.c_void_p, "i32": ctypes.c_int, "i64": ctypes.c_longlong,
         "i32*": ctypes.POINTER(ctypes.c_int),
         "u32*": ctypes.POINTER(ctypes.c_uint)}


def parse_signature(signature: str) -> Tuple[Tuple[str, ...], str]:
    """``"ptr i64 -> i32"`` -> ``(("ptr", "i64"), "i32")``."""
    args, ret = signature.split("->")
    return tuple(args.split()), ret.strip()


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile time in this process; 0.0 when reused
    log: str  # nvcc/ptxas output (registers, shared memory, spills)
    checked: bool = False  # load_library's ``check`` has passed


_LOCK = threading.Lock()  # guards _LOADED
_LOADED: Dict[str, BuiltLibrary] = {}
_COUNT_LOCK = threading.Lock()  # guards _COUNTS
_COUNTS: Counter = Counter()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the count ``name``: a kernel's launches (counted by
    ``launch_on_stream``) or the work a wrapper reports beside them."""
    with _COUNT_LOCK:
        _COUNTS[name] += n


def launch_counts() -> Dict[str, int]:
    """Every count since the last ``reset_counts``, by name; a name never
    counted reads 0. Plain (CPU) calls count nothing."""
    with _COUNT_LOCK:
        return Counter(_COUNTS)


def reset_counts() -> None:
    with _COUNT_LOCK:
        _COUNTS.clear()


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


def _load(name: str, out: Path, seconds: float, log: str) -> BuiltLibrary:
    """Load a built library and declare its functions (``SIGNATURES``)."""
    lib = ctypes.CDLL(str(out))
    for fn_name, signature in SIGNATURES[name].items():
        args, ret = parse_signature(signature)
        fn = getattr(lib, fn_name)
        fn.argtypes = [KINDS[k] for k in args]
        fn.restype = KINDS[ret]
    error_string = getattr(lib, f"{name}_error_string")
    error_string.argtypes, error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return BuiltLibrary(lib, out, seconds, log)


def load_library(name: str,
                 check: Optional[Callable[[ctypes.CDLL], None]] = None
                 ) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` (once per source version) and load it,
    every C function declared. ``check(lib)``, where given, runs once, on
    the first call that passes it, and raises where the library does not
    match what its caller expects."""
    built = _LOADED.get(name)
    if built is not None and (check is None or built.checked):
        return built
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = _load(name, *_compile(name))
        built = _LOADED[name]
        if check is not None and not built.checked:
            check(built.lib)
            built.checked = True
        return built


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
    ``error_string(code)`` naming it; a launch that succeeds counts one
    under ``what``. ``device`` names the device where the launcher takes no
    tensor (its pointers come in ``args``)."""
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
    count(what)


def build_all(names: Sequence[str]) -> Dict[str, BuiltLibrary]:
    """Build several kernels at once, one ``nvcc`` per source, all started
    together, then load each. Raises the first build failure."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        compiled = dict(zip(names, pool.map(_compile, names)))
    with _LOCK:
        for name, built in compiled.items():
            if name not in _LOADED:
                _LOADED[name] = _load(name, *built)
        return {name: _LOADED[name] for name in names}
