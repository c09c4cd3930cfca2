"""PocketNeRF's structural priors (its structural_priors.py), in plain
PyTorch: a Manhattan frame from k-means over the rendered normals, floor
and wall masks from the normals' up component, and the Manhattan,
planarity and normal-consistency losses. The random parts (k-means start,
planarity pairs, consistency rays) are inputs, as the benchmark hands them
to both sides."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

CONFIDENCE = 0.4
NORMAL_THRESHOLD = 0.5
KMEANS_ITERS = 10


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-8)


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    count = m.sum()
    return (x * m).sum() / torch.clamp_min(count, 1.0), count


def manhattan_frame(normals: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """k-means (k = 3) over the unit normals whose length exceeds the
    confidence threshold, then the nearest rotation to the centres (the
    orthogonal polar factor u @ vt of their SVD) with its last column
    negated where its determinant is negative; the identity below 20
    confident normals or 30 rays."""
    with torch.no_grad():
        n = _normalize(normals.detach())
        conf = torch.linalg.norm(normals.detach(), dim=-1) > CONFIDENCE
        w = conf.to(torch.float32)
        c = _normalize(centers)
        for _ in range(KMEANS_ITERS):
            onehot = F.one_hot(torch.argmax(n @ c.T, -1), 3).to(torch.float32) \
                * w[:, None]
            counts = onehot.sum(0)
            means = _normalize(onehot.T @ n / torch.clamp_min(counts[:, None], 1.0))
            c = torch.where(counts[:, None] > 0, means, c)
        u, _, vt = torch.linalg.svd(c.T.double())
        frame = (u @ vt).float()
        if torch.linalg.det(frame) < 0:
            frame = torch.cat([frame[:, :2], -frame[:, 2:]], 1)
        if int(conf.sum()) < 20 or normals.shape[0] < 30:
            frame = torch.eye(3, device=normals.device)
        return frame


def structural_loss(depth: torch.Tensor, normals: torch.Tensor,
                    coords: Optional[torch.Tensor], weights: Dict[str, float],
                    draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The sum of the three weighted losses of a batch."""
    nn_ = _normalize(normals)
    stable = torch.linalg.norm(normals, dim=-1) > 0.1
    enough = stable.sum() >= 10
    up = torch.abs(nn_[:, 2])
    floor = stable & (up > NORMAL_THRESHOLD) & enough
    wall = stable & (up < 1.0 - NORMAL_THRESHOLD) & enough
    n_floor, n_wall = floor.sum(), wall.sum()
    frame = manhattan_frame(normals, draws["centers"])

    fl, _ = _masked_mean(torch.clamp(1.0 - torch.abs(nn_ @ frame[:, 2]), 0, 1), floor)
    floor_t = torch.where(n_floor > 50, fl * 0.5, 0.0)
    best = torch.maximum(torch.abs(nn_ @ frame[:, 0]), torch.abs(nn_ @ frame[:, 1]))
    wl, _ = _masked_mean(torch.clamp(1.0 - best, 0, 1), wall)
    wall_t = torch.where(n_wall > 30, wl * 0.3, 0.0)
    best_all = torch.amax(torch.abs(nn_ @ frame), -1)
    gl, n_conf = _masked_mean(torch.clamp(1.0 - best_all, 0, 1), best_all > 0.5)
    gen_t = torch.where(n_conf > 20, gl * 0.02, 0.0)
    manhattan = weights["manhattan"] * torch.clamp(floor_t + wall_t + gen_t, 0, 0.1)

    n = depth.shape[0]
    if n < 10:
        return manhattan

    def region(idx, mask, count, scale):
        dd = torch.abs(depth[idx[0]] - depth[idx[1]])
        pw = (mask[idx[0]] & mask[idx[1]]).to(torch.float32)
        mean = (dd * pw).sum() / torch.clamp_min(pw.sum(), 1.0)
        return torch.where(count > 5, mean * scale, 0.0)

    other = ~(floor | wall)
    planarity = weights["planarity"] * (
        region(draws["planar_floor"], floor, n_floor, 2.0)
        + region(draws["planar_wall"], wall, n_wall, 1.5)
        + region(draws["planar_other"], other, other.sum(), 0.1))

    i1 = draws["consist_idx"]
    if coords is not None:
        d = torch.linalg.norm(coords[i1][:, None, :] - coords[None, :, :], dim=-1)
        d[torch.arange(i1.shape[0], device=d.device), i1] = math.inf
        i2 = torch.argmin(d, -1)
        sd = torch.gather(d, 1, i2[:, None])[:, 0]
        cos = (nn_[i1] * nn_[i2]).sum(-1)
        consistency = weights["normal_consistency"] * torch.mean(
            torch.exp(-sd * 0.1) * torch.exp(-torch.abs(depth[i1] - depth[i2]))
            * (1.0 - cos))
    else:
        i2 = i1 + 1
        cos = (nn_[i1] * nn_[i2]).sum(-1)
        consistency = weights["normal_consistency"] * torch.mean(
            torch.exp(-torch.abs(depth[i1] - depth[i2])) * (1.0 - cos))
    return manhattan + planarity + consistency
