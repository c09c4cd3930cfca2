"""Distortion loss: compact, non-overlapping per-ray weight distributions
(losses/distortion.py of the JAX package; ``--distortion_loss_weight``).

The Mip-NeRF 360 interval distortion (Barron et al., CVPR 2022, eq. 15)
for point samples, with the ray distances normalised to [0, 1] by
(near, far):

    L_dist = sum_ij w_i w_j |s_i - s_j|  +  (1/3) sum_i w_i^2 delta_i

It penalises compositing weight spread along a ray or split into several
clusters, the floaters of few-shot training. The pairwise term is an
``[N, S, S]`` reduction; the samples arrive sorted from both sampling
paths. ``interval_distortion`` is the same loss on intervals given by their
edges (nerfacto's form), with no stretching of the last one.
"""

from __future__ import annotations

import torch


def distortion_loss(weights: torch.Tensor, z_vals: torch.Tensor,
                    near: torch.Tensor, far: torch.Tensor) -> torch.Tensor:
    """Mean over rays of the distortion of ``weights`` ``[N, S]`` at the
    sorted depths ``z_vals`` ``[N, S]``, normalised by ``near``/``far``
    ``[N, 1]``. ``delta_i`` is the interval between the midpoints around
    sample ``i`` (the edge samples take the half interval)."""
    s = (z_vals - near) / torch.clamp_min(far - near, 1e-10)
    ds = torch.abs(s[..., :, None] - s[..., None, :])
    pair = torch.sum(weights[..., :, None] * weights[..., None, :] * ds,
                     dim=(-2, -1))
    mids = 0.5 * (s[..., 1:] + s[..., :-1])
    upper = torch.cat([mids, s[..., -1:]], dim=-1)
    lower = torch.cat([s[..., :1], mids], dim=-1)
    self_term = torch.sum(weights ** 2 * (upper - lower), dim=-1) / 3.0
    return torch.mean(pair + self_term)


def interval_distortion(edges: torch.Tensor, weights: torch.Tensor
                        ) -> torch.Tensor:
    """Mean over rays of the distortion of ``weights`` ``[N, S]`` on the
    intervals between ``edges`` ``[N, S + 1]`` (Mip-NeRF 360 eq. 15):
    ``sum_ij w_i w_j |m_i - m_j| + (1/3) sum_i w_i^2 (e_{i+1} - e_i)``,
    ``m_i`` the midpoints."""
    mids = 0.5 * (edges[..., 1:] + edges[..., :-1])
    dm = torch.abs(mids[..., :, None] - mids[..., None, :])
    inter = torch.sum(weights * torch.sum(weights[..., None, :] * dm, dim=-1),
                      dim=-1)
    intra = torch.sum(weights ** 2 * (edges[..., 1:] - edges[..., :-1]),
                      dim=-1) / 3.0
    return torch.mean(inter + intra)
