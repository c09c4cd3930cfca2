"""Block-hash encode forward: gather a tile row, contract it with tent weights.

``tent_contract(table, flat_row, p, side, F) -> [M, F]`` f32 computes, for
each (point, level) row m,

    out[m, f] = sum_lane row(m)[f, lane] * w(m, lane)
    w(m, lane) = tent(lx - px) * tent(ly - py) * tent(lz - pz)

with ``row(m)`` the table row ``flat_row[m]``: trilinear interpolation
inside the gathered tile (the tent weights vanish except at the 8 vertices
bracketing p).

Two layouts of a table row. The master (the trainable table, the JAX
layout) is ``[rows, F*lpf]``, feature planes: element ``f*lpf + lane``.
``tent_contract`` reads the **packed** copy ``[rows, lpf, F]``, vertex
major: element ``lane*F + f``, so the F features of a vertex are adjacent
and one vector load fetches them. ``pack_rows`` makes that copy (casting
to the gather dtype in the same pass); the 3-D shape marks it.

Two implementations of the same function live here:

- ``tent_contract_plain``: a gather, tent weights over every lane, and a
  per-feature sum, the jnp form of
  ``indoor_nerf_tpu/ops/blockhash.py::_gather_interp`` (:411-423). It
  takes the master layout (a packed copy is un-packed first). The CPU path
  and the reference the kernel is held against.
- the CUDA kernel ``csrc/tent_contract.cu``, which fuses the gather and
  reads only the 8 bracketing vertices, one vector each. It replaces the
  Pallas kernel ``indoor_nerf_tpu/ops/pallas/tent_contract.py::
  tent_contract`` and the XLA gather that fed it. One thread takes a
  (point, level) row and all its features, in memory order. L2 sector
  requests of the gather bound it on an H100, not device memory (the bf16
  flagship table lives in L2) and not arithmetic; PERF.md holds its times,
  and those of the work orders that were tried and dropped.

``tent_contract`` and ``pack_rows`` dispatch on the tensors' device: CPU
tensors take the plain version; CUDA tensors launch the kernel or raise.
There is no fallback from a failed build or launch to the plain version.

Numerics: the kernel accumulates in f32 and returns f32. The TPU
production variant rounds the weighted products to bf16 before a 0/1 MXU
matmul and emits bf16; the port's choice is a deliberate precision
upgrade (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import torch

from indoor_nerf_tpu_torch.cuda_build import launch_on_stream, load_library
from indoor_nerf_tpu_torch.ops.constants import device_constant


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


def pack_rows_plain(table: torch.Tensor, F: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The master layout ``[rows, F*lpf]`` as the packed ``[rows, lpf, F]``
    in ``dtype``: a view, a transpose and one copy."""
    lpf = table.shape[1] // F
    return table.view(table.shape[0], F, lpf).transpose(1, 2).to(
        dtype).contiguous()


def unpack_rows(packed: torch.Tensor) -> torch.Tensor:
    """A packed ``[rows, lpf, F]`` tensor back in the master layout
    ``[rows, F*lpf]``, same dtype (plain PyTorch on every device)."""
    rows, lpf, F = packed.shape
    return packed.transpose(1, 2).reshape(rows, F * lpf)


def pack_rows(table: torch.Tensor, F: int,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``table [rows, F*lpf] f32 -> [rows, lpf, F]`` in ``dtype`` (f32 or
    bf16, rounded to nearest even as ``Tensor.to``). CPU tensors: the plain
    version. CUDA tensors: the pack kernel of ``csrc/tent_contract.cu``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the packed copy is float32 or bfloat16, got {dtype}")
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] % F:
        raise TypeError(f"table must be float32 [rows, F*lpf] with F={F}, got "
                        f"{table.dtype} {tuple(table.shape)}")
    if table.device.type == "cpu":
        return pack_rows_plain(table, F, dtype)
    if table.device.type != "cuda":
        raise ValueError(f"pack_rows runs on cpu or cuda, not {table.device}")
    n_rows, lpf = table.shape[0], table.shape[1] // F
    packed = torch.empty((n_rows, lpf, F), dtype=dtype, device=table.device)
    if n_rows == 0:
        return packed
    lib = load_library("tent_contract").lib
    fn = (lib.tent_pack_rows_bf16 if dtype == torch.bfloat16
          else lib.tent_pack_rows_f32)
    launch_on_stream(fn, lib.tent_contract_error_string, "pack_rows",
                     (("table", table), ("packed", packed)), n_rows, F, lpf)
    return packed


def int8_level_scales(table: torch.Tensor, n_levels: int) -> torch.Tensor:
    """The int8 gather's per-level scales ``[n_levels]`` f32: each level's
    largest magnitude (at least 1e-12) over 127, the JAX ``_gather_rows``
    rule (ops/blockhash.py:349-351). The divisor is a tensor on the
    table's device: PyTorch's CUDA division by a Python number multiplies
    by its rounded reciprocal, one ulp away from the quotient."""
    absmax = torch.amax(torch.abs(table.reshape(n_levels, -1)), dim=1)
    return torch.clamp_min(absmax, 1e-12) / device_constant(
        127.0, torch.float32, table.device)


def dequantize_int8_plain(table: torch.Tensor, n_levels: int) -> torch.Tensor:
    """The master ``[L*R, W]`` f32 with every entry rounded to its level's
    int8 grid and dequantized, ``round(x / s) * s`` in f32 (``torch.round``
    rounds half to even, as ``jnp.round``): the values the JAX int8 gather
    dequantizes after the fetch (ops/blockhash.py:352-354)."""
    R = table.shape[0] // n_levels
    s = int8_level_scales(table, n_levels).repeat_interleave(R)[:, None]
    return torch.round(table / s) * s


def pack_rows_int8_plain(table: torch.Tensor, F: int,
                         n_levels: int) -> torch.Tensor:
    """``pack_rows_int8``'s plain version: dequantize, then pack in f32."""
    return pack_rows_plain(dequantize_int8_plain(table, n_levels), F,
                           torch.float32)


def pack_rows_int8(table: torch.Tensor, F: int, n_levels: int) -> torch.Tensor:
    """The pack pass of the int8 gather: ``table [L*R, F*lpf] f32 -> [L*R,
    lpf, F] f32`` holding ``dequantize_int8_plain(table)``, packed in f32
    because ``q * scale`` is not exact in bf16. CPU tensors: the plain
    version. CUDA tensors: the scales (one reduction), then the int8 pack
    kernel of ``csrc/tent_contract.cu``, which rounds, dequantizes and packs
    in one pass, bit for bit the plain version."""
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] % F \
            or table.shape[0] % n_levels:
        raise TypeError(f"table must be float32 [L*R, F*lpf] with F={F}, "
                        f"L={n_levels}, got {table.dtype} {tuple(table.shape)}")
    if table.device.type == "cpu":
        return pack_rows_int8_plain(table, F, n_levels)
    if table.device.type != "cuda":
        raise ValueError(f"pack_rows_int8 runs on cpu or cuda, not {table.device}")
    n_rows, lpf = table.shape[0], table.shape[1] // F
    packed = torch.empty((n_rows, lpf, F), dtype=torch.float32,
                         device=table.device)
    if n_rows == 0:
        return packed
    scale = int8_level_scales(table, n_levels)
    lib = load_library("tent_contract").lib
    launch_on_stream(lib.tent_pack_rows_int8, lib.tent_contract_error_string,
                     "pack_rows_int8",
                     (("table", table), ("scale", scale), ("packed", packed)),
                     n_rows, F, lpf, n_rows // n_levels)
    return packed


def tent_contract_plain(table: torch.Tensor, flat_row: torch.Tensor,
                        p: torch.Tensor, side: int, F: int) -> torch.Tensor:
    """The plain PyTorch version: gather rows, weight every lane, sum.

    ``table`` is in the master layout ``[rows, F*lpf]``; a packed 3-D copy
    is un-packed first."""
    if table.dim() == 3:
        table = unpack_rows(table)
    lpf = table.shape[1] // F
    rows = table.index_select(0, flat_row.long()).to(torch.float32)
    w = tent_weights(p, side, lpf)
    return torch.stack(
        [torch.sum(rows[:, f * lpf:(f + 1) * lpf] * w, dim=1)
         for f in range(F)], dim=1)


def _check(table, flat_row, p, side, F) -> None:
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    if table.dim() != 3 or table.shape[2] != F:
        raise ValueError(f"table must be packed [rows, lpf, F] with F={F} "
                         f"(pack_rows), got {tuple(table.shape)}")
    lpf = table.shape[1]
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
    """``(table [L*R, lpf, F] f32|bf16 packed, flat_row [M] int32, p [M, 3]
    f32) -> [M, F]`` f32. CPU tensors: plain version. CUDA tensors: the
    kernel."""
    _check(table, flat_row, p, side, F)
    if table.device.type == "cpu":
        return tent_contract_plain(table, flat_row, p, side, F)
    if table.device.type != "cuda":
        raise ValueError(f"tent_contract runs on cpu or cuda, not {table.device}")
    if table.data_ptr() % 16:
        raise ValueError("the packed table must start at a multiple of 16 "
                         "bytes (the kernel loads vectors)")
    M = flat_row.shape[0]
    out = torch.empty((M, F), dtype=torch.float32, device=table.device)
    if M == 0:
        return out
    if M >= (1 << 31) * 256:
        raise ValueError(f"M={M} exceeds one launch's grid")
    lib = load_library("tent_contract").lib
    fn = (lib.tent_contract_bf16 if table.dtype == torch.bfloat16
          else lib.tent_contract_f32)
    launch_on_stream(
        fn, lib.tent_contract_error_string, "tent_contract",
        (("table", table), ("flat_row", flat_row), ("p", p), ("out", out)),
        M, F, table.shape[1], side, table.shape[0])
    return out
