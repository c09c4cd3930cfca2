"""Pinhole ray generation and the NDC projection (ops/rays.py of the JAX
package): ``get_rays`` and ``ndc_rays`` in torch, and the numpy twins the
host-side samplers and bounding-box estimators use, copied."""

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


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o: torch.Tensor,
             rays_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project rays into normalized device coordinates (LLFF forward-facing),
    in the JAX ``ndc_rays``' operation order."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]
    )
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]
    )
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)


# --- Host-side (numpy) variants used by the bbox estimators -------------------


def get_ray_directions_np(H: int, W: int, focal: float) -> np.ndarray:
    """Camera-frame ray directions, centered-principal-point convention (no
    +0.5 pixel centering)."""
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32),
        indexing="xy",
    )
    return np.stack(
        [(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], -1
    )


def get_rays_from_directions_np(
    directions: np.ndarray, c2w: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """World-frame rays with normalized directions, flattened to ``[H*W, 3]``."""
    rays_d = directions @ c2w[:3, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)


def get_ndc_rays_np(
    H: int, W: int, focal: float, near: float,
    rays_o: np.ndarray, rays_d: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy NDC projection used by the LLFF bbox estimator (``d2 = 1 -
    o2`` here, ``-2 near / oz`` in ``ndc_rays``: equal when near == 1)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]

    o0 = -1.0 / (W / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2

    return np.stack([o0, o1, o2], -1), np.stack([d0, d1, d2], -1)
