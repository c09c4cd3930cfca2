"""Total-variation loss on the hash grid (ops/tv.py of the JAX package).

A random cube of grid vertices per level is hashed and its squared
adjacent differences summed. The cube sizes are static per level; the cube
origins are the step's draws (``draw_tv_origins``), which the parity tests
fill with the JAX ``randint`` of each level's key.

``patch_depth_regularizer`` is the ``--reg_views`` loss on the depth of
rendered ray patches, plain tensor ops under autograd.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from indoor_nerf_tpu_torch.ops.encoding import HashGridConfig, level_resolutions
from indoor_nerf_tpu_torch.ops.hashing import spatial_hash


def _level_cube_size(resolution: float, min_resolution: int) -> int:
    """Static cube edge length of one level (a copy of the JAX function)."""
    min_cube = min_resolution - 1
    max_cube = 50
    return int(math.floor(np.clip(resolution / 10.0, min_cube, max_cube)))


def _cubes(config: HashGridConfig):
    """``(resolution, cube)`` of each level, as ints."""
    res = level_resolutions(config)
    return [(int(r), _level_cube_size(r, config.base_resolution)) for r in res]


def draw_tv_origins(generator: torch.Generator, config: HashGridConfig
                    ) -> torch.Tensor:
    """The cube origins ``[L, 3]`` int64, each axis uniform in
    ``[0, resolution - cube)`` (the JAX ``randint`` per level)."""
    dev = generator.device
    return torch.stack([
        torch.randint(0, res - cube, (3,), generator=generator, device=dev)
        for res, cube in _cubes(config)])


def total_variation_loss(table: torch.Tensor, config: HashGridConfig,
                         origins: torch.Tensor,
                         levels: Optional[Sequence[int]] = None,
                         row_offset: int = 0) -> torch.Tensor:
    """Sum over levels of the squared differences of adjacent vertices'
    features in the cube at ``origins[level]``, divided by its edge length.
    ``table`` is the fused ``[L * T, F]`` hash table, or with ``levels``
    (a level-sharded table, ``parallel/tp.py``) the block of those levels,
    whose first row is row ``row_offset`` of the full table."""
    total = torch.zeros((), dtype=torch.float32, device=table.device)
    cubes = _cubes(config)
    for level in (range(config.n_levels) if levels is None else levels):
        cube = cubes[level][1]
        ax = torch.arange(cube + 1, device=table.device)
        g = origins[level].to(table.device)[:, None] + ax[None, :]  # [3, C+1]
        cube_idx = torch.stack(torch.meshgrid(g[0], g[1], g[2], indexing="ij"),
                               dim=-1)  # [C+1, C+1, C+1, 3]
        flat = spatial_hash(cube_idx, config.log2_hashmap_size) \
            + (level * config.table_size - row_offset)
        emb = table[flat]  # [C+1, C+1, C+1, F]
        tv_x = torch.sum((emb[1:, :, :, :] - emb[:-1, :, :, :]) ** 2)
        tv_y = torch.sum((emb[:, 1:, :, :] - emb[:, :-1, :, :]) ** 2)
        tv_z = torch.sum((emb[:, :, 1:, :] - emb[:, :, :-1, :]) ** 2)
        total = total + (tv_x + tv_y + tv_z) / cube
    return total


def patch_depth_regularizer(depth: torch.Tensor, acc: torch.Tensor,
                            patch: int, near: float, far: float,
                            mode: str = "tv") -> torch.Tensor:
    """Depth smoothness over the ``--reg_views`` patches (JAX ops/tv.py:78):
    ``depth`` and ``acc`` are the flat ``[P * patch**2]`` maps of a render
    of ``UnobservedPatchSampler`` rays.

    ``"tv"``: the mean squared first differences of depth / (far - near)
    along each patch axis (RegNeRF). ``"planar"``: the mean squared second
    differences of the disparity ``(far - near) * acc / max(depth, 1e-6)``,
    which is affine in the pixel coordinates on a plane, so a plane costs
    zero at any slant, and an empty ray (acc 0) has disparity 0."""
    d = depth.reshape(-1, patch, patch)
    if mode == "planar":
        a = acc.reshape(-1, patch, patch)
        nd = (far - near) * a / torch.clamp_min(d, 1e-6)
        return (torch.mean(torch.square(nd[:, 2:, :] - 2.0 * nd[:, 1:-1, :]
                                        + nd[:, :-2, :]))
                + torch.mean(torch.square(nd[:, :, 2:] - 2.0 * nd[:, :, 1:-1]
                                          + nd[:, :, :-2])))
    nd = d / (far - near)
    return (torch.mean(torch.square(nd[:, 1:, :] - nd[:, :-1, :]))
            + torch.mean(torch.square(nd[:, :, 1:] - nd[:, :, :-1])))
