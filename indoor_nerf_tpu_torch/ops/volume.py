"""Alpha compositing of raw field outputs (ops/volume.py of the JAX package)."""

from __future__ import annotations

from typing import Dict, Optional

import torch


def draw_sigma_noise(generator: torch.Generator, shape, std: float
                     ) -> torch.Tensor:
    """The ``raw_noise_std`` draw: standard normal ``shape`` times ``std``."""
    return torch.randn(shape, generator=generator,
                       device=generator.device) * std


class _NonzeroCumprod(torch.autograd.Function):
    """``torch.cumprod`` along the last axis of factors that are never zero,
    with the backward of torch's own no-zero case, ``reversed
    cumsum(grad * out) / x``. torch's backward first checks the input for
    zeros on the host, a read that waits for the card; the transmittance
    factors ``1 - alpha + 1e-10`` are positive."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return torch.flip(torch.cumsum(torch.flip(out * grad, [-1]), -1), [-1]) / x


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
                white_bkgd: bool = False,
                sigma_noise: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """Composite raw ``[N, S, 4]`` (rgb logits, sigma) samples into per-ray
    maps; raw ``[N, S, 7]`` also carries a unit normal per sample.

    ``sigma_noise`` ``[N, S]`` is added to sigma before the activation (the
    JAX ``raw_noise_std`` draw, already scaled); serving passes none.

    Returns rgb_map [N,3], disp_map [N], acc_map [N], weights [N,S],
    depth_map [N] and sparsity_loss [N] (the entropy of the per-ray weight
    distribution with a residual background state); with normals also
    normal_map [N,3], the weighted sum of the sample normals divided by
    ``sqrt(|n|^2 + 1e-6)`` (JAX volume.py:98-109): a soft normalisation
    whose jacobian stays bounded on empty rays and which leaves an unstable
    normal shorter than 1, as the priors' stability mask reads it."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    if sigma_noise is not None:
        sigma = sigma + sigma_noise

    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = _NonzeroCumprod.apply(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1)
    )[..., :-1]
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    acc_map = torch.sum(weights, dim=-1)
    depth_map = torch.sum(weights * z_vals, dim=-1) / torch.clamp_min(acc_map, 1e-10)
    disp_map = 1.0 / torch.clamp_min(depth_map, 1e-10)

    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    probs = torch.cat(
        [weights, torch.clamp_min(1.0 - acc_map[..., None], 1e-6)], dim=-1)
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    sparsity_loss = -torch.sum(
        probs * torch.log(torch.clamp_min(probs, 1e-30)), dim=-1)

    out = {
        "rgb_map": rgb_map,
        "disp_map": disp_map,
        "acc_map": acc_map,
        "weights": weights,
        "depth_map": depth_map,
        "sparsity_loss": sparsity_loss,
    }
    if raw.shape[-1] >= 7:
        normal_map = torch.sum(weights[..., None] * raw[..., 4:7], dim=-2)
        sq = torch.sum(normal_map * normal_map, dim=-1, keepdim=True)
        out["normal_map"] = normal_map * torch.rsqrt(sq + 1e-6)
    return out
