"""Distortion loss: compact, non-overlapping per-ray weight distributions
(losses/distortion.py of the JAX package; ``--distortion_loss_weight``).

The Mip-NeRF 360 interval distortion (Barron et al., CVPR 2022, eq. 15)
for point samples, with the ray distances normalised to [0, 1] by
(near, far):

    L_dist = sum_ij w_i w_j |s_i - s_j|  +  (1/3) sum_i w_i^2 delta_i

It penalises compositing weight spread along a ray or split into several
clusters, the floaters of few-shot training. The pairwise term is an
``[N, S, S]`` reduction; the samples arrive sorted from both sampling
paths.
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
