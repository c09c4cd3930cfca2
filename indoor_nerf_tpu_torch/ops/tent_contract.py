"""Block-hash encode forward: gather a tile row, contract it with tent weights.

``tent_contract(table, flat_row, p, side, F) -> [M, F]`` f32 computes, for
each (point, level) row m,

    out[m, f] = sum_lane table[flat_row[m], f*lpf + lane] * w(m, lane)
    w(m, lane) = tent(lx - px) * tent(ly - py) * tent(lz - pz)

which is trilinear interpolation inside the gathered tile (the tent weights
vanish except at the 8 vertices bracketing p).

Two implementations of the same function live here:

- ``tent_contract_plain``: a gather, tent weights over every lane, and a
  per-feature sum — the jnp form of
  ``indoor_nerf_tpu/ops/blockhash.py::_gather_interp`` (:411-423). The CPU
  path and the reference the kernel is held against.
- the CUDA kernel ``csrc/tent_contract.cu``, which fuses the gather and
  reads only the 8 bracketing lanes. It replaces the Pallas kernel
  ``indoor_nerf_tpu/ops/pallas/tent_contract.py::tent_contract`` and the
  XLA gather that fed it.

``tent_contract`` dispatches on the tensors' device: CPU tensors take the
plain version; CUDA tensors launch the kernel or raise. There is no
fallback from a failed build or launch to the plain version.

Numerics: the kernel accumulates in f32 and returns f32. The TPU
production variant rounds the weighted products to bf16 before a 0/1 MXU
matmul and emits bf16; the port's choice is a deliberate precision
upgrade (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from indoor_nerf_tpu_torch.cuda_build import launch_on_stream, load_library

_LOCK = threading.Lock()
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count`` (not plain calls)."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _LOCK:
        _launches = 0


def lanes_per_feature(side: int) -> int:
    """Lanes holding one feature's ``side^3`` tile (padded to 64 or 128)."""
    return 128 if side ** 3 > 64 else 64


def tent_factors(p: torch.Tensor, side: int, lanes: int):
    """Per-axis tent weights (tx, ty, tz), each ``[M, lanes]``, for in-tile
    positions ``[M, 3]``.

    Lane l decodes to tile vertex (l//side^2, (l//side)%side, l%side); pad
    lanes >= side^3 decode to x >= side and get zero weight
    (ops/blockhash.py::_tent_weights)."""
    lane = torch.arange(lanes, device=p.device, dtype=torch.int64)
    lx = (lane // (side * side)).to(torch.float32)
    ly = ((lane // side) % side).to(torch.float32)
    lz = (lane % side).to(torch.float32)
    tx = torch.clamp_min(1.0 - torch.abs(lx[None, :] - p[:, 0:1]), 0.0)
    ty = torch.clamp_min(1.0 - torch.abs(ly[None, :] - p[:, 1:2]), 0.0)
    tz = torch.clamp_min(1.0 - torch.abs(lz[None, :] - p[:, 2:3]), 0.0)
    return tx, ty, tz


def tent_weights(p: torch.Tensor, side: int, lanes: int) -> torch.Tensor:
    """Tent-product weights ``[M, lanes]`` for in-tile positions ``[M, 3]``."""
    tx, ty, tz = tent_factors(p, side, lanes)
    return tx * ty * tz


def tent_contract_plain(table: torch.Tensor, flat_row: torch.Tensor,
                        p: torch.Tensor, side: int, F: int) -> torch.Tensor:
    """The plain PyTorch version: gather rows, weight every lane, sum."""
    lpf = table.shape[1] // F
    rows = table.index_select(0, flat_row.long()).to(torch.float32)
    w = tent_weights(p, side, lpf)
    return torch.stack(
        [torch.sum(rows[:, f * lpf:(f + 1) * lpf] * w, dim=1)
         for f in range(F)], dim=1)


def _check(table, flat_row, p, side, F) -> None:
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    if table.dim() != 2 or table.shape[1] % F:
        raise ValueError(f"table must be [rows, F*lpf] with F={F}, got "
                         f"{tuple(table.shape)}")
    lpf = table.shape[1] // F
    if side < 2 or side ** 3 > lpf:
        raise ValueError(f"a side-{side} tile does not fit {lpf} lanes")
    if flat_row.dtype != torch.int32 or flat_row.dim() != 1:
        raise TypeError("flat_row must be a 1-D int32 tensor, got "
                        f"{flat_row.dtype} {tuple(flat_row.shape)}")
    if p.dtype != torch.float32 or tuple(p.shape) != (flat_row.shape[0], 3):
        raise ValueError(f"p must be float32 [{flat_row.shape[0]}, 3], got "
                         f"{p.dtype} {tuple(p.shape)}")
    if not (table.device == flat_row.device == p.device):
        raise ValueError("table, flat_row and p must be on one device, got "
                         f"{table.device}, {flat_row.device}, {p.device}")


def tent_contract(table: torch.Tensor, flat_row: torch.Tensor,
                  p: torch.Tensor, side: int, F: int) -> torch.Tensor:
    """``(table [L*R, F*lpf] f32|bf16, flat_row [M] int32, p [M, 3] f32)
    -> [M, F] f32``. CPU tensors: plain version. CUDA tensors: the kernel."""
    global _launches
    _check(table, flat_row, p, side, F)
    if table.device.type == "cpu":
        return tent_contract_plain(table, flat_row, p, side, F)
    if table.device.type != "cuda":
        raise ValueError(f"tent_contract runs on cpu or cuda, not {table.device}")
    M = flat_row.shape[0]
    out = torch.empty((M, F), dtype=torch.float32, device=table.device)
    if M == 0:
        return out
    if M * F >= (1 << 31) * 256:
        raise ValueError(f"M={M} exceeds one launch's grid")
    lib = _library()
    fn = (lib.tent_contract_bf16 if table.dtype == torch.bfloat16
          else lib.tent_contract_f32)
    launch_on_stream(
        fn, lib.tent_contract_error_string, "tent_contract",
        (("table", table), ("flat_row", flat_row), ("p", p), ("out", out)),
        M, F, table.shape[1] // F, side, table.shape[0])
    with _LOCK:
        _launches += 1
    return out


_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library, with every C signature declared."""
    global _lib
    if _lib is None:
        lib = load_library("tent_contract").lib
        for fn in (lib.tent_contract_f32, lib.tent_contract_bf16):
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.tent_contract_error_string.argtypes = [ctypes.c_int]
        lib.tent_contract_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
