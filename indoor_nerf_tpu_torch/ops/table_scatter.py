"""Block-hash encode backward: tent-weighted cotangent rows, scatter-added.

``table_scatter(g, p, flat_row, n_rows, side, lpf, dtype) -> [n_rows, F*lpf]``
f32 computes the table gradient of the encode forward
(``ops/tent_contract.py``), in the master's layout: for each (point,
level) row m,

    grad[flat_row[m], f*lpf + lane] += round(g[m, f] * w(m, lane))

with ``w`` the tent-product weights and ``round`` the rounding to ``dtype``
(bf16 for the flagship, none for f32), applied to each entry once, before
any sum; the sums are f32.

Two implementations of the same function live here:

- ``table_scatter_plain``: the cotangent rows ``[M, F*lpf]``
  (``cot_rows``, the torch form of
  ``indoor_nerf_tpu/ops/blockhash.py::_cot_rows``), rounded to ``dtype``,
  then ``index_add_`` into a zero table. The CPU path and the reference the
  kernel is held against.
- the CUDA kernels of ``csrc/table_scatter.cu``. They replace the Pallas
  kernel ``indoor_nerf_tpu/ops/pallas/table_scatter.py::scatter_add_table``
  and the cotangent formation that fed it: only the 8 nonzero entries per
  (row, feature) are formed, in registers, so no ``[M, F*lpf]`` array
  reaches device memory. The sums go into a zeroed vertex-major packed f32
  buffer ``[n_rows, lpf, F]`` (the layout of ``tent_contract.pack_rows``),
  where the F features of a vertex are adjacent and take ONE vector
  reduction; a second pass un-packs the buffer into the master's layout.
  One thread takes a (point, level) row and all its features, in memory
  order. Atomic reductions at L2 bound it on an H100, not bytes; PERF.md
  holds its times, and those of the work order and the run merge that were
  tried and dropped.

``table_scatter`` dispatches on the tensors' device: CPU tensors take the
plain version; CUDA tensors launch the kernels or raise. There is no
fallback from a failed build or launch to the plain version.

Numerics: both sum the same rounded entries in f32; the kernel's sums are
taken in an order that changes from run to run, so results agree to f32
rounding of the sums, not bitwise.
"""

from __future__ import annotations

import torch

from indoor_nerf_tpu_torch.cuda_build import launch_on_stream, load_library
from indoor_nerf_tpu_torch.ops.tent_contract import tent_factors


def cot_rows(g: torch.Tensor, p: torch.Tensor, side: int,
             lpf: int) -> torch.Tensor:
    """Cotangent rows ``cot[m, f*lpf + v] = g[m, f] * tent(m, v)`` ``[M, F*lpf]``
    f32, the products in the JAX order ``((g * tx) * ty) * tz``."""
    F = g.shape[1]
    tx, ty, tz = tent_factors(p, side, lpf)
    g_sel = g.repeat_interleave(lpf, dim=1)
    return g_sel * tx.repeat(1, F) * ty.repeat(1, F) * tz.repeat(1, F)


def table_scatter_plain(g: torch.Tensor, p: torch.Tensor,
                        flat_row: torch.Tensor, n_rows: int, side: int,
                        lpf: int, dtype: torch.dtype) -> torch.Tensor:
    """The plain PyTorch version: dense cotangent rows, rounded, index_add_."""
    cot = cot_rows(g, p, side, lpf)
    if dtype != torch.float32:
        cot = cot.to(dtype).to(torch.float32)
    out = torch.zeros((n_rows, cot.shape[1]), dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, flat_row.long(), cot)


def _check(g, p, flat_row, n_rows, side, lpf, dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scatter dtype must be float32 or bfloat16, got {dtype}")
    if g.dtype != torch.float32 or g.dim() != 2:
        raise TypeError(f"g must be a 2-D float32 tensor, got {g.dtype} "
                        f"{tuple(g.shape)}")
    if side < 2 or side ** 3 > lpf:
        raise ValueError(f"a side-{side} tile does not fit {lpf} lanes")
    if flat_row.dtype != torch.int32 or tuple(flat_row.shape) != (g.shape[0],):
        raise TypeError(f"flat_row must be int32 [{g.shape[0]}], got "
                        f"{flat_row.dtype} {tuple(flat_row.shape)}")
    if p.dtype != torch.float32 or tuple(p.shape) != (g.shape[0], 3):
        raise ValueError(f"p must be float32 [{g.shape[0]}, 3], got "
                         f"{p.dtype} {tuple(p.shape)}")
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")
    if not (g.device == p.device == flat_row.device):
        raise ValueError("g, p and flat_row must be on one device, got "
                         f"{g.device}, {p.device}, {flat_row.device}")


def table_scatter(g: torch.Tensor, p: torch.Tensor, flat_row: torch.Tensor,
                  n_rows: int, side: int, lpf: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(g [M, F] f32, p [M, 3] f32, flat_row [M] int32) -> [n_rows, F*lpf]``
    f32 table gradient. CPU tensors: plain version. CUDA tensors: the kernels
    (a zero-fill, the scatter into the packed buffer, the un-pack)."""
    _check(g, p, flat_row, n_rows, side, lpf, dtype)
    if g.device.type == "cpu":
        return table_scatter_plain(g, p, flat_row, n_rows, side, lpf, dtype)
    if g.device.type != "cuda":
        raise ValueError(f"table_scatter runs on cpu or cuda, not {g.device}")
    M, F = g.shape
    if M == 0 or n_rows == 0:
        return torch.zeros((n_rows, F * lpf), dtype=torch.float32,
                           device=g.device)
    if M >= (1 << 31) * 256:
        raise ValueError(f"M={M} exceeds one launch's grid")
    if g.data_ptr() % 16:
        g = g.clone()  # the kernel loads a row of g as one vector
    lib = load_library("table_scatter").lib
    packed = torch.zeros((n_rows, lpf, F), dtype=torch.float32, device=g.device)
    launch_on_stream(
        lib.table_scatter, lib.table_scatter_error_string, "table_scatter",
        (("g", g), ("p", p), ("flat_row", flat_row), ("packed", packed)),
        M, F, lpf, side, n_rows, int(dtype == torch.bfloat16))
    return unpack_grad(packed)


def unpack_grad(packed: torch.Tensor) -> torch.Tensor:
    """The un-pack pass on the card: the packed f32 sums ``[n_rows, lpf, F]``
    of a scatter (this one's or ``ops/group_scatter.py``'s) -> the gradient
    in the master's layout ``[n_rows, F*lpf]``."""
    n_rows, lpf, F = packed.shape
    lib = load_library("table_scatter").lib
    out = torch.empty((n_rows, F * lpf), dtype=torch.float32,
                      device=packed.device)
    launch_on_stream(
        lib.table_scatter_unpack, lib.table_scatter_error_string,
        "table_scatter_unpack", (("packed", packed), ("out", out)),
        n_rows, F, lpf)
    return out
