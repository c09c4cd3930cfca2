"""Tent-product interpolation over gathered 5^3 tiles, with its gradients.

``tile_interp(rows, p) -> [M, 2]`` f32 computes, for rows ``[M, 256]`` f32
that are ALREADY gathered (two 128-lane feature planes of one ``5^3``-vertex
tile each) and in-tile positions ``p`` ``[M, 3]``,

    out[m, f] = sum_{lane < 128} rows[m, f*128 + lane] * w(m, lane)
    w(m, lane) = tent(lx - px) * tent(ly - py) * tent(lz - pz)

It is the port of ``indoor_nerf_tpu/ops/pallas/tile_interp.py::tile_interp``
(a ``jax.custom_vjp``) as a ``torch.autograd.Function``:

- forward: ``tile_interp_fwd`` (CUDA ``csrc/tile_interp.cu::tile_interp_fwd``,
  which replaces the Pallas ``_tile_interp_fwd_tpu``);
- ``d rows[m, f*128 + lane] = g[m, f] * w(m, lane)``: ``tile_interp_bwd_rows``
  (CUDA ``tile_interp_bwd_rows``, which replaces ``_tile_interp_bwd_rows_tpu``);
- ``d p``: plain tensor code (``tile_interp_dp``), as in the JAX package,
  which computes it outside any Pallas kernel (:160-177). It is computed,
  and ``rows`` kept for it, only when ``p`` needs a gradient (2 GiB of rows
  at the training step's width otherwise held for nothing).

Each of the two kernels has its plain PyTorch version here
(``tile_interp_fwd_plain``, ``tile_interp_bwd_rows_plain``): the CPU path
and what the kernel is held against. The wrappers dispatch on the tensors'
device: CPU tensors take the plain version; CUDA tensors launch the kernel
or raise. There is no fallback from a failed build or launch.

The tent derivative: ``d tent(l - p) / d p = sign(l - p)`` on the open
support ``|l - p| < 1`` and 0 elsewhere, the JAX package's choice
(:166-168). At an integer ``p`` (a kink) that gives 0 for the vertex under
``p`` (sign 0) and for its two neighbours (``|l - p| = 1`` is outside the
open support), so the axis contributes no gradient there.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from indoor_nerf_tpu_torch.cuda_build import launch_on_stream, load_library
from indoor_nerf_tpu_torch.ops.tent_contract import tent_factors, tent_weights

LANES = 128
SIDE = 5  # a 5^3 tile fills 125 of the 128 lanes
KERNELS = ("tile_interp_fwd", "tile_interp_bwd_rows")

_LOCK = threading.Lock()
_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def launch_count(kernel: str) -> int:
    """Launches of ``kernel`` (one of ``KERNELS``) since the last
    ``reset_launch_count`` (plain calls do not count)."""
    return _launches[kernel]


def reset_launch_count() -> None:
    with _LOCK:
        for k in KERNELS:
            _launches[k] = 0


def tile_interp_fwd_plain(rows: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch forward: weight every lane, sum each plane."""
    w = tent_weights(p, SIDE, LANES)
    return torch.stack([torch.sum(rows[:, :LANES] * w, dim=1),
                        torch.sum(rows[:, LANES:] * w, dim=1)], dim=1)


def tile_interp_bwd_rows_plain(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch ``d rows`` ``[M, 256]``: ``g[m, f] * w(m, lane)``."""
    w = tent_weights(p, SIDE, LANES)
    return torch.cat([g[:, 0:1] * w, g[:, 1:2] * w], dim=1)


def tile_interp_dp(rows: torch.Tensor, p: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """``d p`` ``[M, 3]`` by the tent derivative and the product rule across
    the axes (JAX ``_bwd``, :160-177); plain tensor code on every device."""
    tx, ty, tz = tent_factors(p, SIDE, LANES)
    lane = torch.arange(LANES, device=p.device, dtype=torch.int64)
    coords = ((lane // (SIDE * SIDE)), (lane // SIDE) % SIDE, lane % SIDE)

    def dtent(axis):
        d = coords[axis].to(torch.float32)[None, :] - p[:, axis:axis + 1]
        return torch.where(torch.abs(d) < 1.0, torch.sign(d),
                           torch.zeros_like(d))

    gval = g[:, 0:1] * rows[:, :LANES] + g[:, 1:2] * rows[:, LANES:]
    return torch.stack([torch.sum(gval * dtent(0) * ty * tz, dim=1),
                        torch.sum(gval * tx * dtent(1) * tz, dim=1),
                        torch.sum(gval * tx * ty * dtent(2), dim=1)], dim=1)


def _check(name: str, t: torch.Tensor, width: int, like: torch.Tensor) -> None:
    if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != width:
        raise TypeError(f"{name} must be float32 [M, {width}], got {t.dtype} "
                        f"{tuple(t.shape)}")
    if t.shape[0] != like.shape[0] or t.device != like.device:
        raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does not go "
                         f"with {tuple(like.shape)} on {like.device}")


def _launch(kernel: str, tensors, M: int) -> None:
    """Launch ``kernel`` over ``tensors`` (its arguments in C order) or
    raise; counts the launch."""
    device = tensors[0][1].device
    if device.type != "cuda":  # before the build: nothing is built for it
        raise ValueError(f"{kernel} runs on cpu or cuda, not {device}")
    lib = _library()
    launch_on_stream(getattr(lib, kernel), lib.tile_interp_error_string,
                     kernel, tensors, M, align=16)
    with _LOCK:
        _launches[kernel] += 1


def tile_interp_fwd(rows: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``(rows [M, 256] f32, p [M, 3] f32) -> [M, 2]`` f32. CPU tensors: the
    plain version. CUDA tensors: the kernel."""
    _check("rows", rows, 2 * LANES, rows)
    _check("p", p, 3, rows)
    if rows.device.type == "cpu":
        return tile_interp_fwd_plain(rows, p)
    M = rows.shape[0]
    out = torch.empty((M, 2), dtype=torch.float32, device=rows.device)
    if M:
        _launch("tile_interp_fwd", (("rows", rows), ("p", p), ("out", out)), M)
    return out


def tile_interp_bwd_rows(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``(p [M, 3] f32, g [M, 2] f32) -> d rows [M, 256]`` f32. CPU tensors:
    the plain version. CUDA tensors: the kernel."""
    _check("p", p, 3, p)
    _check("g", g, 2, p)
    if p.device.type == "cpu":
        return tile_interp_bwd_rows_plain(p, g)
    M = p.shape[0]
    drows = torch.empty((M, 2 * LANES), dtype=torch.float32, device=p.device)
    if M:
        _launch("tile_interp_bwd_rows", (("p", p), ("g", g), ("drows", drows)),
                M)
    return drows


class _TileInterp(torch.autograd.Function):
    """``tile_interp`` with its hand-written backward."""

    @staticmethod
    def forward(ctx, rows, p):
        need_dp = ctx.needs_input_grad[1]
        ctx.save_for_backward(p, rows if need_dp else None)
        return tile_interp_fwd(rows, p)

    @staticmethod
    def backward(ctx, g):
        p, rows = ctx.saved_tensors
        g = g.contiguous()
        drows = tile_interp_bwd_rows(p, g) if ctx.needs_input_grad[0] else None
        dp = tile_interp_dp(rows, p, g) if ctx.needs_input_grad[1] else None
        return drows, dp


def tile_interp(rows: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Interpolate gathered tiles: rows ``[M, 256]`` f32 (two 128-lane
    feature planes), ``p`` ``[M, 3]`` positions within the tile -> features
    ``[M, 2]``, differentiable in both."""
    return _TileInterp.apply(rows, p)


_lib = None


def _library() -> ctypes.CDLL:
    """The built kernel library, with every C signature declared."""
    global _lib
    if _lib is None:
        lib = load_library("tile_interp").lib
        for name in KERNELS:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.tile_interp_error_string.argtypes = [ctypes.c_int]
        lib.tile_interp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
