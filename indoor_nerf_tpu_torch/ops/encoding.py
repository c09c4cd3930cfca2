"""Input encodings (ops/encoding.py of the JAX package): the multiresolution
hash grid, its level resolutions, SH view features and the frequency PE.

``HashGridConfig`` and ``level_resolutions`` are copies (the JAX module
imports jax). The hash grid's 16 tables live in one ``[L * T, F]`` tensor,
as in the JAX package: the corner indices of every level are computed at
once, and one gather reads them. Its gradient is the gather's adjoint,
``index_add_`` of the weighted cotangent rows into a dense table (span
``encode_bwd``); no hand-written kernel: the JAX package computes this
encode in XLA (``jnp.take``), outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch.profiler import record_function

from indoor_nerf_tpu_torch.ops.constants import device_constant
from indoor_nerf_tpu_torch.ops.hashing import PRIMES


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    """Static geometry of the multiresolution hash grid (a copy of the JAX
    ``HashGridConfig``)."""

    bbox_min: Tuple[float, float, float]
    bbox_max: Tuple[float, float, float]
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    finest_resolution: int = 512

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features_per_level


def level_resolutions(config) -> np.ndarray:
    """Per-level grid resolutions, float32 ``[L]``.

    ``config`` is any object with ``n_levels``, ``base_resolution`` and
    ``finest_resolution``. res_l = floor(base * b^l) with geometric growth
    b = exp((ln finest - ln base) / (L - 1)), in float32 like the reference.
    """
    base = np.float32(config.base_resolution)
    finest = np.float32(config.finest_resolution)
    if config.n_levels > 1:
        b = np.exp(
            (np.log(finest) - np.log(base)) / np.float32(config.n_levels - 1)
        ).astype(np.float32)
    else:
        b = np.float32(1.0)
    levels = np.arange(config.n_levels, dtype=np.float32)
    return np.floor(base * b**levels).astype(np.float32)


def init_hash_table(generator: torch.Generator, config: HashGridConfig,
                    device=None) -> torch.Tensor:
    """The fused hash table ``[L * T, F]`` ~ U(-1e-4, 1e-4) (same shape and
    distribution as the JAX init; the numbers differ)."""
    shape = (config.n_levels * config.table_size, config.n_features_per_level)
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    return u * 2e-4 - 1e-4


def hash_grid_indices(x: torch.Tensor, config: HashGridConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Voxel-corner table rows and trilinear weights of all levels at once.

    Returns (flat_idx ``[N, L, 8]`` int32 rows of the fused ``[L*T, F]``
    table, weights ``[N, L, 3]`` f32 in [0, 1), keep_mask ``[N]`` bool: x
    inside the box; points outside are clamped to it).

    One ulp in ``rel`` moves a point across a voxel face, and so to another
    corner and another hash row: the op order is the JAX one, in f32 (the
    grid size as ``(max - min) / res``, then a division by it). The hash of
    the 8 corners is formed per axis, ``h = hx ^ hy ^ hz`` with each term
    masked: the XOR of the masked terms is the masked hash, so the corner
    rows equal ``spatial_hash`` of the corner coordinates."""
    dev = x.device
    box_min = device_constant(config.bbox_min, torch.float32, dev)
    box_max = device_constant(config.bbox_max, torch.float32, dev)
    res = device_constant(level_resolutions(config), torch.float32, dev)

    keep_mask = torch.all((x >= box_min) & (x <= box_max), dim=-1)
    xc = torch.minimum(torch.maximum(x, box_min), box_max)
    grid_size = (box_max - box_min)[None, :] / res[:, None]  # [L, 3]
    rel = (xc[:, None, :] - box_min) / grid_size[None, :, :]  # [N, L, 3]
    bottom_left = torch.floor(rel)
    weights = rel - bottom_left
    bl = bottom_left.to(torch.int64)

    mask = config.table_size - 1
    per_axis = []
    for axis in range(3):
        c = bl[..., axis]
        per_axis.append(torch.stack([(c * PRIMES[axis]) & mask,
                                     ((c + 1) * PRIMES[axis]) & mask],
                                    -1).to(torch.int32))
    hx, hy, hz = per_axis  # [N, L, 2] each: the corner's bit 0 or 1
    hashed = (hx[..., :, None, None] ^ hy[..., None, :, None]
              ^ hz[..., None, None, :])  # [N, L, 2, 2, 2]
    level_offset = (torch.arange(config.n_levels, dtype=torch.int32,
                                 device=dev) * config.table_size)
    flat_idx = hashed.reshape(x.shape[0], config.n_levels, 8) \
        + level_offset[None, :, None]
    return flat_idx, weights, keep_mask


def corner_weights(weights: torch.Tensor) -> torch.Tensor:
    """The 8 trilinear corner weights ``[..., 8]`` of ``[..., 3]`` positions
    in the voxel: the product over x, y, z (in this order) of ``w`` where
    the corner's bit is 1, else ``1 - w``, as the JAX ``trilinear_interp``
    forms it, without its ``[..., 8, 3]`` intermediate."""
    f = torch.stack([1.0 - weights, weights], dim=-1)  # [..., 3, 2]
    cw = (f[..., 0, :, None, None] * f[..., 1, None, :, None]
          * f[..., 2, None, None, :])  # [..., 2, 2, 2]
    return cw.reshape(*weights.shape[:-1], 8)


def trilinear_interp(corner_feats: torch.Tensor, weights: torch.Tensor
                     ) -> torch.Tensor:
    """Trilinear interpolation of ``[..., 8, F]`` corner features at
    ``[..., 3]`` voxel positions -> ``[..., F]``."""
    return torch.sum(corner_weights(weights)[..., None] * corner_feats, dim=-2)


class _CornerSum(torch.autograd.Function):
    """``feats[m] = sum_c cw[m, c] * table[idx[m, c]]`` with the table
    gradient formed as the gather's adjoint: the weighted cotangent rows
    added into a dense zero table with ``index_add_`` (atomics on the card:
    the order of the f32 sums varies from run to run)."""

    @staticmethod
    def forward(ctx, table, flat_idx, cw):
        idx = flat_idx.reshape(-1)
        rows = table.index_select(0, idx).view(*cw.shape, table.shape[-1])
        ctx.save_for_backward(idx, cw)
        ctx.table_shape = table.shape
        return torch.sum(cw[..., None] * rows, dim=-2)

    @staticmethod
    def backward(ctx, g):
        idx, cw = ctx.saved_tensors
        with record_function("encode_bwd"):
            rows = (cw[..., None] * g[..., None, :]).reshape(idx.shape[0], -1)
            d_table = torch.zeros(ctx.table_shape, dtype=g.dtype,
                                  device=g.device)
            d_table.index_add_(0, idx, rows)
        return d_table, None, None


def hash_encode(x: torch.Tensor, table: torch.Tensor, config: HashGridConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multiresolution hash encoding of ``[N, 3]`` points with the fused
    ``[L * T, F]`` table -> (features ``[N, L * F]``, keep_mask ``[N]``).
    Differentiable in ``table`` (not in ``x``)."""
    flat_idx, weights, keep_mask = hash_grid_indices(x, config)
    feats = _CornerSum.apply(table, flat_idx, corner_weights(weights))
    return feats.reshape(x.shape[0], config.out_dim), keep_mask


# Real SH coefficients (ops/encoding.py:178-187).
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def sh_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real spherical harmonics of unit directions ``[..., 3]`` -> ``[..., degree**2]``."""
    if not 1 <= degree <= 5:
        raise ValueError(f"degree must be in [1, 5], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    comps = [torch.full_like(x, _C0)]
    if degree > 1:
        comps += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        comps += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree > 3:
        comps += [
            _C3[0] * y * (3 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4 * zz - xx - yy),
            _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            _C3[4] * x * (4 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3 * yy),
        ]
    if degree > 4:
        comps += [
            _C4[0] * xy * (xx - yy),
            _C4[1] * yz * (3 * xx - yy),
            _C4[2] * xy * (7 * zz - 1),
            _C4[3] * yz * (7 * zz - 3),
            _C4[4] * (zz * (35 * zz - 30) + 3),
            _C4[5] * xz * (7 * zz - 3),
            _C4[6] * (xx - yy) * (7 * zz - 1),
            _C4[7] * xz * (xx - 3 * yy),
            _C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(comps, dim=-1)


def positional_encode_dim(multires: int, input_dims: int = 3,
                          include_input: bool = True) -> int:
    """Output dimension of ``positional_encode``."""
    return input_dims * (2 * multires + (1 if include_input else 0))


def positional_encode(x: torch.Tensor, multires: int,
                      include_input: bool = True) -> torch.Tensor:
    """The classic NeRF sin/cos encoding ``[x, sin(f0 x), cos(f0 x), sin(f1
    x), ...]`` with bands ``2^linspace(0, multires - 1, multires)`` (exact
    powers of two in f32, as in the JAX form)."""
    comps = [x] if include_input else []
    freqs = 2.0 ** torch.linspace(0.0, multires - 1, multires)
    for f in freqs.tolist():
        comps.append(torch.sin(x * f))
        comps.append(torch.cos(x * f))
    return torch.cat(comps, dim=-1)
