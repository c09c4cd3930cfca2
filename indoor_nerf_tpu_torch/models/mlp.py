"""NeRFSmall (models/mlp.py of the JAX package) as an ``nn.Module``.

Weights keep the JAX layout ``[in_dim, out_dim]`` (``y = x @ w``), so the
bridge moves them across without a transpose. The state-dict keys
(``sigma_net.0.w``) mirror the JAX pytree paths (``sigma_net[0]["w"]``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn


def init_linear(generator: torch.Generator, in_dim: int, out_dim: int,
                bias: bool = True, device=None) -> nn.ParameterDict:
    """Torch-default Linear init U(-1/sqrt(fan_in), 1/sqrt(fan_in)), stored
    ``{"w": [in_dim, out_dim], "b": [out_dim]}``."""
    bound = 1.0 / np.sqrt(in_dim)

    def uniform(*shape):
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=device)
        return nn.Parameter(u * (2 * bound) - bound)

    p = nn.ParameterDict({"w": uniform(in_dim, out_dim)})
    if bias:
        p["b"] = uniform(out_dim)
    return p


def _linear(p: nn.ParameterDict, x: torch.Tensor,
            compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w (+ b)``; with ``compute_dtype`` the inputs and weights are
    rounded to it and the products accumulate in f32, as the JAX
    ``preferred_element_type=float32`` dot does. (A bf16 x bf16 product is
    exact in f32, so rounding first and multiplying in f32 is that dot.)"""
    w = p["w"]
    if compute_dtype is not None:
        x = x.to(compute_dtype).to(torch.float32)
        w = w.to(compute_dtype).to(torch.float32)
    y = x @ w
    if "b" in p:
        y = y + p["b"]
    return y


class NeRFSmall(nn.Module):
    """Instant-NGP-style sigma net + color net, bias-free Linears.

    forward(input_pts [N, input_ch], input_views [N, input_ch_views] | None)
    -> [N, 4] = (rgb logits, sigma); the sigmoid is applied in compositing.
    """

    def __init__(self, sigma_net, color_net):
        super().__init__()
        self.sigma_net = nn.ModuleList(sigma_net)
        self.color_net = nn.ModuleList(color_net)

    def forward(self, input_pts: torch.Tensor,
                input_views: Optional[torch.Tensor],
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return apply_nerf_small(self, input_pts, input_views, compute_dtype)


def init_nerf_small(generator: torch.Generator, input_ch: int = 32,
                    input_ch_views: int = 16, num_layers: int = 2,
                    hidden_dim: int = 64, geo_feat_dim: int = 15,
                    num_layers_color: int = 3, hidden_dim_color: int = 64,
                    device=None) -> NeRFSmall:
    """Init NeRFSmall (``predict_normals`` is not ported: ROADMAP.md Queue 1
    item 5, training extensions)."""
    sigma_net = []
    for l in range(num_layers):
        in_dim = input_ch if l == 0 else hidden_dim
        out_dim = 1 + geo_feat_dim if l == num_layers - 1 else hidden_dim
        sigma_net.append(init_linear(generator, in_dim, out_dim, bias=False,
                                     device=device))
    color_net = []
    for l in range(num_layers_color):
        in_dim = input_ch_views + geo_feat_dim if l == 0 else hidden_dim_color
        out_dim = 3 if l == num_layers_color - 1 else hidden_dim_color
        color_net.append(init_linear(generator, in_dim, out_dim, bias=False,
                                     device=device))
    return NeRFSmall(sigma_net, color_net)


def apply_nerf_small(model: NeRFSmall, input_pts: torch.Tensor,
                     input_views: Optional[torch.Tensor],
                     compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Forward NeRFSmall -> ``[N, 4]`` (rgb logits, sigma)."""
    h = input_pts
    for l, layer in enumerate(model.sigma_net):
        h = _linear(layer, h, compute_dtype)
        if l != len(model.sigma_net) - 1:
            h = torch.relu(h)

    sigma, geo_feat = h[..., :1], h[..., 1:]
    h = geo_feat if input_views is None else torch.cat(
        [input_views, geo_feat], dim=-1)
    for l, layer in enumerate(model.color_net):
        h = _linear(layer, h, compute_dtype)
        if l != len(model.color_net) - 1:
            h = torch.relu(h)
    return torch.cat([h, sigma], dim=-1)
