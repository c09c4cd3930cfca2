"""Within-row (lane) gather of 128-lane rows, with its gradient.

``lane_select(values, idx) -> [N, k]`` computes ``out[i, j] = values[i,
idx[i, j]]`` for values ``[N, 128]`` f32 and lane indices ``idx`` ``[N, k]``
int32 in ``[0, 128)``, ``k <= 128``. Its gradient w.r.t. ``values`` is the
one-hot sum ``dvalues[i, l] = sum_j g[i, j] * (idx[i, j] == l)``; repeated
indices add.

It is the port of ``indoor_nerf_tpu/ops/pallas/lane_gather.py::lane_select``
(a ``jax.custom_vjp``; there ``k`` is a third, static argument, here it is
``idx.shape[1]``) as a ``torch.autograd.Function``. The block-hash encoder
once picked the 8 voxel corners out of each fetched row with it; no path of
either package calls it now, and it stays the public op it is there.

- forward: CUDA ``csrc/lane_gather.cu::lane_select_fwd`` (replaces the
  Pallas ``_select_tpu``); plain version ``lane_select_plain``
  (``torch.gather``);
- backward: CUDA ``lane_select_grad`` (replaces ``_grad_tpu``), which sums
  in ``j`` order without atomics, so it is deterministic; plain version
  ``lane_select_grad_plain`` (the one-hot masked sum of the JAX fallback,
  :129-132, which holds an ``[N, k, 128]`` array).

The wrappers dispatch on the tensors' device: CPU tensors take the plain
version; CUDA tensors launch the kernel or raise. There is no fallback from
a failed build or launch. An index outside ``[0, 128)`` is the caller's
error: on the CPU ``lane_select`` raises; on the card it is not checked
(that would synchronize the device), the forward kernel writes a NaN for it
and the backward kernel drops it, and neither touches memory outside the
row.
"""

from __future__ import annotations

import torch

from indoor_nerf_tpu_torch.cuda_build import launch_on_stream, load_library

LANES = 128
KERNELS = ("lane_select_fwd", "lane_select_grad")


def lane_select_plain(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch forward: ``torch.gather`` along the lanes."""
    return torch.gather(values, 1, idx.long())


def lane_select_grad_plain(idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch backward ``[N, 128]``: the one-hot masked sum."""
    lanes = torch.arange(LANES, dtype=idx.dtype, device=idx.device)
    hot = idx[:, :, None] == lanes
    return torch.sum(torch.where(hot, g[:, :, None], torch.zeros_like(g[:, :, None])),
                     dim=1)


def _check(values_shape, idx: torch.Tensor, other: torch.Tensor,
           other_name: str) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[1] > LANES:
        raise TypeError(f"idx must be int32 [N, k <= {LANES}], got "
                        f"{idx.dtype} {tuple(idx.shape)}")
    if other.dtype != torch.float32 or tuple(other.shape) != tuple(values_shape):
        raise TypeError(f"{other_name} must be float32 "
                        f"{list(values_shape)}, got {other.dtype} "
                        f"{tuple(other.shape)}")
    if idx.device != other.device:
        raise ValueError(f"idx and {other_name} must be on one device, got "
                         f"{idx.device}, {other.device}")


def _launch(kernel: str, tensors, N: int, k: int) -> None:
    """Launch ``kernel`` over ``tensors`` (its arguments in C order) or
    raise."""
    device = tensors[0][1].device
    if device.type != "cuda":  # before the build: nothing is built for it
        raise ValueError(f"{kernel} runs on cpu or cuda, not {device}")
    lib = load_library("lane_gather").lib
    launch_on_stream(getattr(lib, kernel), lib.lane_gather_error_string,
                     kernel, tensors, N, k, align=16)


def lane_select_fwd(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(values [N, 128] f32, idx [N, k] int32) -> [N, k]`` f32. CPU
    tensors: the plain version (indices checked). CUDA tensors: the kernel."""
    _check((idx.shape[0], LANES), idx, values, "values")
    if values.device.type == "cpu":
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= LANES):
            raise IndexError(f"lane indices must lie in [0, {LANES})")
        return lane_select_plain(values, idx)
    N, k = idx.shape
    out = torch.empty((N, k), dtype=torch.float32, device=values.device)
    if N * k:
        _launch("lane_select_fwd",
                (("values", values), ("idx", idx), ("out", out)), N, k)
    return out


def lane_select_grad(idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``(idx [N, k] int32, g [N, k] f32) -> dvalues [N, 128]`` f32. CPU
    tensors: the plain version. CUDA tensors: the kernel."""
    _check(idx.shape, idx, g, "g")
    if g.device.type == "cpu":
        return lane_select_grad_plain(idx, g)
    N, k = idx.shape
    if k == 0:
        return torch.zeros((N, LANES), dtype=torch.float32, device=g.device)
    dvalues = torch.empty((N, LANES), dtype=torch.float32, device=g.device)
    if N:
        _launch("lane_select_grad",
                (("idx", idx), ("g", g), ("dvalues", dvalues)), N, k)
    return dvalues


class _LaneSelect(torch.autograd.Function):
    """``lane_select`` with its hand-written backward."""

    @staticmethod
    def forward(ctx, values, idx):
        ctx.save_for_backward(idx)
        return lane_select_fwd(values, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return lane_select_grad(idx, g.contiguous()), None


def lane_select(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather ``k`` lanes from each 128-lane row: ``values`` ``[N, 128]``
    f32, ``idx`` ``[N, k]`` int32 in ``[0, 128)`` -> ``[N, k]`` with
    ``out[i, j] = values[i, idx[i, j]]``, differentiable in ``values``."""
    return _LaneSelect.apply(values, idx)
