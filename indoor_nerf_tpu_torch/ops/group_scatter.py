"""Grouped block-hash encode backward: group-merged cotangent rows, scatter-added.

``group_scatter(g, row, p, groups, n_rows, side, lpf, dtype) -> [n_rows, F*lpf]``
f32 computes the table gradient of the grouped encode
(``ops/blockhash.py::block_hash_encode_grouped``). Level l of a ray's S
samples splits into groups of ``groups[l]`` = G consecutive samples; each
group adds ONE row to its anchor tile ``row``:

    grad[row[r, s0, l], f*lpf + lane] +=
        round(sum_{s in group} g[r, s, l*F + f] * w(p[r, s, l], lane))

with ``w`` the tent-product weights at the member's position in the anchor
tile (``ops/blockhash.py::_grouped_coords``), the member sum in f32, in
member order, and ``round`` the rounding to ``dtype`` (bf16 for the
flagship, none for f32) applied once to that sum, then summed in f32. This
is the JAX order: the group sum before the cast
(``indoor_nerf_tpu/ops/blockhash.py:871-872``). At G = 1 it is
``table_scatter``.

Two implementations of the same function live here:

- ``group_scatter_plain``: per class of equal G, the dense per-sample
  cotangent rows (``ops/table_scatter.py::cot_rows``), summed over the
  members in f32, rounded, then ``index_add_`` into a zero table. The CPU
  path and the reference the kernel is held against.
- the CUDA kernel ``csrc/group_scatter.cu``, one launch for every level
  and group, which merges a group's entries in shared memory and adds each
  touched entry with one f32 atomic. It replaces the Pallas kernel
  ``indoor_nerf_tpu/ops/pallas/table_scatter.py::scatter_add_table_ragged``
  and the cotangent formation and group sum that fed it.

``group_scatter`` dispatches on the tensors' device: CPU tensors take the
plain version; CUDA tensors launch the kernel or raise. There is no
fallback from a failed build or launch to the plain version.

Numerics: both form bitwise the same rounded group sums; the kernel's
atomics land in an order that changes from run to run, so results agree
to f32 rounding of the table sums, not bitwise.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import torch

from indoor_nerf_tpu_torch.cuda_build import launch_on_stream, load_library
from indoor_nerf_tpu_torch.ops.table_scatter import cot_rows

MAX_LEVELS = 32  # the kernel's level table

_LOCK = threading.Lock()
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count`` (not plain calls)."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _LOCK:
        _launches = 0


def group_scatter_plain(g: torch.Tensor, row: torch.Tensor, p: torch.Tensor,
                        groups: Sequence[int], n_rows: int, side: int,
                        lpf: int, dtype: torch.dtype) -> torch.Tensor:
    """The plain PyTorch version: per G, dense cotangent rows, the member
    sum in member order, rounded, index_add_."""
    Rn, S, L = row.shape
    F = g.shape[-1] // L
    W = F * lpf
    g4 = g.reshape(Rn, S, L, F)
    out = torch.zeros((n_rows, W), dtype=torch.float32, device=g.device)
    for G in sorted(set(groups)):
        lv = torch.tensor([l for l, k in enumerate(groups) if k == G],
                          device=g.device)
        cot = cot_rows(g4[:, :, lv].reshape(-1, F), p[:, :, lv].reshape(-1, 3),
                       side, lpf).reshape(Rn, S // G, G, len(lv), W)
        acc = cot[:, :, 0]
        for j in range(1, G):
            acc = acc + cot[:, :, j]
        if dtype != torch.float32:
            acc = acc.to(dtype).to(torch.float32)
        anchor_row = row[:, ::G][:, :, lv]  # [Rn, S // G, Lc]
        out.index_add_(0, anchor_row.reshape(-1).long(), acc.reshape(-1, W))
    return out


def _check(g, row, p, groups, n_rows, side, lpf, dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scatter dtype must be float32 or bfloat16, got {dtype}")
    if row.dtype != torch.int32 or row.dim() != 3:
        raise TypeError(f"row must be a 3-D int32 tensor [Rn, S, L], got "
                        f"{row.dtype} {tuple(row.shape)}")
    Rn, S, L = row.shape
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"{L} levels: the kernel takes 1 to {MAX_LEVELS}")
    if (g.dtype != torch.float32 or g.dim() != 3 or g.shape[:2] != (Rn, S)
            or g.shape[2] % L or g.shape[2] == 0):
        raise TypeError(f"g must be float32 [{Rn}, {S}, {L} * F], got "
                        f"{g.dtype} {tuple(g.shape)}")
    if p.dtype != torch.float32 or tuple(p.shape) != (Rn, S, L, 3):
        raise ValueError(f"p must be float32 [{Rn}, {S}, {L}, 3], got "
                         f"{p.dtype} {tuple(p.shape)}")
    if len(groups) != L or any(int(G) < 1 or S % int(G) for G in groups):
        raise ValueError(f"groups must hold {L} sizes that divide S = {S}, "
                         f"got {tuple(groups)}")
    if lpf not in (64, 128) or side < 2 or side ** 3 > lpf:
        raise ValueError(f"a side-{side} tile in {lpf} lanes: the kernel "
                         "takes 64 or 128 lanes that hold the tile")
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")
    if not (g.device == row.device == p.device):
        raise ValueError("g, row and p must be on one device, got "
                         f"{g.device}, {row.device}, {p.device}")


def group_scatter(g: torch.Tensor, row: torch.Tensor, p: torch.Tensor,
                  groups: Sequence[int], n_rows: int, side: int, lpf: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(g [Rn, S, L*F] f32, row [Rn, S, L] int32, p [Rn, S, L, 3] f32,
    groups [L]) -> [n_rows, F*lpf]`` f32 table gradient. The row of a
    group is read at its first member. CPU tensors: plain version. CUDA
    tensors: the kernel."""
    global _launches
    _check(g, row, p, groups, n_rows, side, lpf, dtype)
    if g.device.type == "cpu":
        return group_scatter_plain(g, row, p, groups, n_rows, side, lpf, dtype)
    if g.device.type != "cuda":
        raise ValueError(f"group_scatter runs on cpu or cuda, not {g.device}")
    Rn, S, L = row.shape
    F = g.shape[2] // L
    out = torch.zeros((n_rows, F * lpf), dtype=torch.float32, device=g.device)
    if Rn * S == 0:
        return out
    threads = Rn * sum(S // int(G) for G in groups) * F
    if threads >= (1 << 31) * 64:
        raise ValueError(f"{threads} work items exceed one launch's grid")
    lib = _library()
    c_groups = (ctypes.c_int * L)(*(int(G) for G in groups))
    launch_on_stream(
        lib.group_scatter, lib.group_scatter_error_string, "group_scatter",
        (("g", g), ("p", p), ("row", row), ("out", out)),
        Rn, S, L, F, lpf, side, n_rows, c_groups, int(dtype == torch.bfloat16))
    with _LOCK:
        _launches += 1
    return out


_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library, with every C signature declared."""
    global _lib
    if _lib is None:
        lib = load_library("group_scatter").lib
        lib.group_scatter.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
        lib.group_scatter.restype = ctypes.c_int
        lib.group_scatter_error_string.argtypes = [ctypes.c_int]
        lib.group_scatter_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
