"""Pinhole ray generation (ops/rays.py of the JAX package)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def get_rays(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel ray origins and directions: (rays_o, rays_d) ``[H, W, 3]``.

    ``K`` ``[3, 3]`` and ``c2w`` ``[3, 4]`` are float32 on the target device."""
    dev = c2w.device
    i, j = torch.meshgrid(
        torch.arange(W, dtype=torch.float32, device=dev),
        torch.arange(H, dtype=torch.float32, device=dev),
        indexing="xy",
    )
    dirs = torch.stack(
        [(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1], -torch.ones_like(i)],
        dim=-1,
    )
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], dim=-1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_np(H: int, W: int, K, c2w) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy twin of get_rays for host-side scene generation."""
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32),
        indexing="xy",
    )
    dirs = np.stack(
        [(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1], -np.ones_like(i)], -1
    )
    rays_d = np.sum(dirs[..., np.newaxis, :] * c2w[:3, :3], -1)
    rays_o = np.broadcast_to(c2w[:3, -1], np.shape(rays_d))
    return rays_o, rays_d
