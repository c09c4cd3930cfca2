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
  and group. It replaces the Pallas kernel
  ``indoor_nerf_tpu/ops/pallas/table_scatter.py::scatter_add_table_ragged``
  and the cotangent formation and group sum that fed it. One thread takes
  a member, a (ray, sample, level) row with all F features, in memory
  order. It merges in registers: member j emits the vertices of its
  bracket that no earlier member brackets, each with the later members'
  shares added in member order, so every vertex of the group's union is
  added once, with ONE vector reduction into the zeroed vertex-major
  packed f32 buffer ``[n_rows, lpf, F]`` that ``table_scatter`` uses; that
  op's un-pack pass returns the master's layout. A member whose own and
  later cotangents are all 0, or whose vertices earlier members all
  bracket, returns at once. Atomic reductions at L2 bound it on an H100,
  not bytes; PERF.md holds its times beside those of the design it
  replaced (one thread per (group, feature), a shared-memory slab of
  ``lpf`` sums per thread, one scalar atomic per touched entry) and of
  what was tried and dropped (one thread per group; forced occupancy).

``group_scatter_anchored`` is the same kernel with the anchor math inside:
it takes the lattice coordinates ``v0``, ``w`` that the encode's forward
keeps and computes each group's anchor row and its members' positions
itself, bit for bit ``_grouped_coords`` (``anchor_coords`` writes them out
so that tests can hold that). The training path on the card runs this
form; its plain version is ``_grouped_coords`` followed by
``group_scatter_plain`` (``ops/blockhash.py::grouped_scatter_plain``).

``group_scatter`` dispatches on the tensors' device: CPU tensors take the
plain version; CUDA tensors launch the kernel or raise. There is no
fallback from a failed build or launch to the plain version.

Numerics: both form bitwise the same rounded group sums; the kernel's
reductions land in an order that changes from run to run, so results agree
to f32 rounding of the table sums, not bitwise (bitwise where every table
row takes one group).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import torch

from indoor_nerf_tpu_torch.cuda_build import launch_on_stream, load_library
from indoor_nerf_tpu_torch.ops.constants import device_constant
from indoor_nerf_tpu_torch.ops.table_scatter import cot_rows, unpack_grad

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


def merged_rows(g: torch.Tensor, p: torch.Tensor, groups: Sequence[int],
                side: int, lpf: int, dtype: torch.dtype):
    """Per class of equal G: ``(G, levels [Lc], rows [Rn, S // G, Lc, F*lpf])``,
    each group's dense merged cotangent row: the members' rows summed in
    f32 in member order, then rounded to ``dtype``."""
    Rn, S, L = p.shape[:3]
    F = g.shape[-1] // L
    g4 = g.reshape(Rn, S, L, F)
    for G in sorted(set(groups)):
        lv = device_constant([l for l, k in enumerate(groups) if k == G],
                             torch.int64, g.device)
        cot = cot_rows(g4[:, :, lv].reshape(-1, F), p[:, :, lv].reshape(-1, 3),
                       side, lpf).reshape(Rn, S // G, G, len(lv), F * lpf)
        acc = cot[:, :, 0]
        for j in range(1, G):
            acc = acc + cot[:, :, j]
        if dtype != torch.float32:
            acc = acc.to(dtype).to(torch.float32)
        yield G, lv, acc


def group_scatter_plain(g: torch.Tensor, row: torch.Tensor, p: torch.Tensor,
                        groups: Sequence[int], n_rows: int, side: int,
                        lpf: int, dtype: torch.dtype) -> torch.Tensor:
    """The plain PyTorch version: per G, dense cotangent rows, the member
    sum in member order, rounded, index_add_."""
    W = g.shape[-1] // row.shape[2] * lpf
    out = torch.zeros((n_rows, W), dtype=torch.float32, device=g.device)
    for G, lv, acc in merged_rows(g, p, groups, side, lpf, dtype):
        anchor_row = row[:, ::G][:, :, lv]  # [Rn, S // G, Lc]
        out.index_add_(0, anchor_row.reshape(-1).long(), acc.reshape(-1, W))
    return out


def _check(g, coords, groups, n_rows, side, lpf, dtype) -> None:
    """``coords``: ``(name, tensor, dtype, trailing shape)`` of the two
    coordinate tensors, each ``[Rn, S, L, *trailing]``; ``g`` None where
    only coordinates are asked for."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scatter dtype must be float32 or bfloat16, got {dtype}")
    _, first, _, last = coords[0]
    if first.dim() != 3 + len(last):
        raise TypeError(f"{coords[0][0]} must be [Rn, S, L{', 3' * len(last)}]"
                        f", got {tuple(first.shape)}")
    Rn, S, L = first.shape[:3]
    for name, t, want, last in coords:
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if tuple(t.shape) != (Rn, S, L, *last):
            raise ValueError(f"{name} must be {[Rn, S, L, *last]}, got "
                             f"{tuple(t.shape)}")
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"{L} levels: the kernel takes 1 to {MAX_LEVELS}")
    if g is not None and (
            g.dtype != torch.float32 or g.dim() != 3 or g.shape[:2] != (Rn, S)
            or g.shape[2] % L or g.shape[2] == 0):
        raise TypeError(f"g must be float32 [{Rn}, {S}, {L} * F], got "
                        f"{g.dtype} {tuple(g.shape)}")
    if len(groups) != L or any(int(G) < 1 or S % int(G) for G in groups):
        raise ValueError(f"groups must hold {L} sizes that divide S = {S}, "
                         f"got {tuple(groups)}")
    if side < 2 or side ** 3 > lpf:
        raise ValueError(f"a side-{side} tile does not fit {lpf} lanes")
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")
    devices = [t.device for t in (g, *(c[1] for c in coords)) if t is not None]
    if any(d != devices[0] for d in devices):
        raise ValueError("g and the coordinates must be on one device, got "
                         + ", ".join(map(str, devices)))


def _c_groups(groups):
    return (ctypes.c_int * len(groups))(*(int(G) for G in groups))


def _scatter(launcher, name, g, tensors, groups, n_rows, side, lpf, dtype,
             *hash_args) -> torch.Tensor:
    """Zero-fill the packed buffer, launch ``launcher`` over ``(g, *tensors,
    packed)``, un-pack; counts one launch."""
    global _launches
    Rn, S, LF = g.shape
    L = len(groups)
    F = LF // L
    if Rn * S == 0 or n_rows == 0:
        return torch.zeros((n_rows, F * lpf), dtype=torch.float32,
                           device=g.device)
    if Rn * S * L >= (1 << 31) * 256:
        raise ValueError(f"{Rn} rays x {S} samples exceed one launch's grid")
    if g.data_ptr() % 16:
        g = g.clone()  # the kernel loads a member's features as one vector
    packed = torch.zeros((n_rows, lpf, F), dtype=torch.float32, device=g.device)
    launch_on_stream(
        launcher, _library().group_scatter_error_string, name,
        (("g", g), *tensors, ("packed", packed)),
        Rn, S, L, F, lpf, side, n_rows, _c_groups(groups), *hash_args,
        int(dtype == torch.bfloat16))
    with _LOCK:
        _launches += 1
    return unpack_grad(packed)


def group_scatter(g: torch.Tensor, row: torch.Tensor, p: torch.Tensor,
                  groups: Sequence[int], n_rows: int, side: int, lpf: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(g [Rn, S, L*F] f32, row [Rn, S, L] int32, p [Rn, S, L, 3] f32,
    groups [L]) -> [n_rows, F*lpf]`` f32 table gradient. The row of a
    group is read at its first member. CPU tensors: plain version. CUDA
    tensors: the kernels (a zero-fill, the merge and scatter into the
    packed buffer, the un-pack)."""
    _check(g, (("row", row, torch.int32, ()), ("p", p, torch.float32, (3,))),
           groups, n_rows, side, lpf, dtype)
    if g.device.type == "cpu":
        return group_scatter_plain(g, row, p, groups, n_rows, side, lpf, dtype)
    if g.device.type != "cuda":
        raise ValueError(f"group_scatter runs on cpu or cuda, not {g.device}")
    return _scatter(_library().group_scatter, "group_scatter", g,
                    (("p", p), ("row", row)), groups, n_rows, side, lpf, dtype)


def _check_anchored(g, v0, w, level_ids, groups, n_rows, side, lpf, dtype,
                    log2_rows, primes) -> None:
    _check(g, (("v0", v0, torch.int32, (3,)), ("w", w, torch.float32, (3,))),
           groups, n_rows, side, lpf, dtype)
    L = len(groups)
    if (level_ids.dtype != torch.int64 or tuple(level_ids.shape) != (L,)
            or level_ids.device != v0.device):
        raise TypeError(f"level_ids must be int64 [{L}] on {v0.device}, got "
                        f"{level_ids.dtype} {tuple(level_ids.shape)} on "
                        f"{level_ids.device}")
    if not 1 <= log2_rows <= 31 or len(primes) != 4:
        raise ValueError(f"log2_rows {log2_rows} (1 to 31) and 4 hash primes, "
                         f"got {len(primes)}")
    if v0.device.type != "cuda":
        raise ValueError(
            f"the anchored form is the kernel's and runs on cuda, not "
            f"{v0.device}; its plain version is "
            "ops/blockhash.py::grouped_scatter_plain")


def _c_primes(primes):
    return (ctypes.c_uint * 4)(*(int(v) for v in primes))


def group_scatter_anchored(g: torch.Tensor, v0: torch.Tensor, w: torch.Tensor,
                           level_ids: torch.Tensor, groups: Sequence[int],
                           n_rows: int, side: int, lpf: int,
                           dtype: torch.dtype, log2_rows: int,
                           primes: Sequence[int]) -> torch.Tensor:
    """``group_scatter`` from the lattice coordinates: ``v0`` int32 and ``w``
    f32 ``[Rn, S, L, 3]`` (``ops/blockhash.py::_vertex_coords``),
    ``level_ids`` int64 ``[L]``; the kernel computes the anchor rows (block
    size ``side - 1``, ``2^log2_rows`` rows per level, the hash's four
    ``primes``) and positions of ``_grouped_coords`` itself. CUDA tensors
    only: it launches the kernels or raises."""
    _check_anchored(g, v0, w, level_ids, groups, n_rows, side, lpf, dtype,
                    log2_rows, primes)
    return _scatter(_library().group_scatter_anchored,
                    "group_scatter_anchored", g,
                    (("v0", v0), ("w", w), ("level_ids", level_ids)), groups,
                    n_rows, side, lpf, dtype, log2_rows, _c_primes(primes))


def anchor_coords(v0: torch.Tensor, w: torch.Tensor, level_ids: torch.Tensor,
                  groups: Sequence[int], side: int, log2_rows: int,
                  primes: Sequence[int]):
    """``(row [Rn, S, L] int32, p [Rn, S, L, 3] f32)`` as
    ``group_scatter_anchored`` computes them on the card, written out by
    the same device code: what the tests hold bit for bit against
    ``ops/blockhash.py::_grouped_coords``. No path calls it."""
    _check_anchored(None, v0, w, level_ids, groups, 0, side, side ** 3,
                    torch.float32, log2_rows, primes)
    Rn, S, L, _ = v0.shape
    row = torch.empty((Rn, S, L), dtype=torch.int32, device=v0.device)
    p = torch.empty((Rn, S, L, 3), dtype=torch.float32, device=v0.device)
    if row.numel():
        lib = _library()
        launch_on_stream(
            lib.group_anchor_coords, lib.group_scatter_error_string,
            "group_anchor_coords",
            (("v0", v0), ("w", w), ("level_ids", level_ids), ("row", row),
             ("p", p)),
            Rn, S, L, side, _c_groups(groups), log2_rows, _c_primes(primes))
    return row, p


_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library, with every C signature declared."""
    global _lib
    if _lib is None:
        lib = load_library("group_scatter").lib
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        groups = ctypes.POINTER(ctypes.c_int)
        primes = ctypes.POINTER(ctypes.c_uint)
        lib.group_scatter.argtypes = [ptr] * 4 + [
            i64, i32, i32, i32, i32, i32, i64, groups, i32, ptr]
        lib.group_scatter_anchored.argtypes = [ptr] * 5 + [
            i64, i32, i32, i32, i32, i32, i64, groups, i32, primes, i32, ptr]
        lib.group_anchor_coords.argtypes = [ptr] * 5 + [
            i64, i32, i32, i32, groups, i32, primes, ptr]
        for fn in (lib.group_scatter, lib.group_scatter_anchored,
                   lib.group_anchor_coords):
            fn.restype = ctypes.c_int
        lib.group_scatter_error_string.argtypes = [ctypes.c_int]
        lib.group_scatter_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
