"""The NeRF MLPs of models/mlp.py of the JAX package as ``nn.Module``s:
``NeRFSmall`` (the grid encoders' net) and ``NeRFBig`` (the classic NeRF of
the PE path, 8 x 256 with a skip at layer 4).

Weights keep the JAX layout ``[in_dim, out_dim]`` (``y = x @ w``), so the
bridge moves them across without a transpose. The state-dict keys
(``sigma_net.0.w``, ``pts_linears.4.b``, ``rgb_linear.w``) mirror the JAX
pytree paths (``sigma_net[0]["w"]``, ...).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

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
            compute_dtype: Optional[torch.dtype] = None,
            w_override: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w (+ b)``, with ``w_override`` in place of ``w`` where given
    (the fake-quantized weight); with ``compute_dtype`` the inputs and
    weights are rounded to it and the products accumulate in f32, as the
    JAX ``preferred_element_type=float32`` dot does. (A bf16 x bf16 product
    is exact in f32, so rounding first and multiplying in f32 is that
    dot.)"""
    w = p["w"] if w_override is None else w_override
    if compute_dtype is not None:
        x = x.to(compute_dtype).to(torch.float32)
        w = w.to(compute_dtype).to(torch.float32)
    y = x @ w
    if "b" in p:
        y = y + p["b"]
    return y


class NeRFSmall(nn.Module):
    """Instant-NGP-style sigma net + color net, bias-free Linears, and with
    ``normal_net`` (``--predict_normals``) two biased Linears from the
    geometry features to a unit normal.

    forward(input_pts [N, input_ch], input_views [N, input_ch_views] | None)
    -> [N, 4] = (rgb logits, sigma), or [N, 7] with the normal; the sigmoid
    is applied in compositing.
    """

    def __init__(self, sigma_net, color_net, normal_net=None):
        super().__init__()
        self.sigma_net = nn.ModuleList(sigma_net)
        self.color_net = nn.ModuleList(color_net)
        if normal_net is not None:
            self.normal_net = nn.ModuleList(normal_net)

    @property
    def predict_normals(self) -> bool:
        return hasattr(self, "normal_net")

    def forward(self, input_pts: torch.Tensor,
                input_views: Optional[torch.Tensor],
                compute_dtype: Optional[torch.dtype] = None,
                weight_quant: Optional[Callable] = None,
                act_quants: Optional[Sequence[Callable]] = None) -> torch.Tensor:
        return apply_nerf_small(self, input_pts, input_views, compute_dtype,
                                weight_quant, act_quants)


def init_nerf_small(generator: torch.Generator, input_ch: int = 32,
                    input_ch_views: int = 16, num_layers: int = 2,
                    hidden_dim: int = 64, geo_feat_dim: int = 15,
                    num_layers_color: int = 3, hidden_dim_color: int = 64,
                    predict_normals: bool = False, device=None) -> NeRFSmall:
    """Init NeRFSmall; with ``predict_normals`` also the normal net
    ``geo_feat_dim -> hidden_dim // 2 -> 3`` (JAX mlp.py:154-158)."""
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
    normal_net = None
    if predict_normals:
        normal_net = [
            init_linear(generator, geo_feat_dim, hidden_dim // 2, device=device),
            init_linear(generator, hidden_dim // 2, 3, device=device),
        ]
    return NeRFSmall(sigma_net, color_net, normal_net)


def apply_nerf_small(model: NeRFSmall, input_pts: torch.Tensor,
                     input_views: Optional[torch.Tensor],
                     compute_dtype: Optional[torch.dtype] = None,
                     weight_quant: Optional[Callable] = None,
                     act_quants: Optional[Sequence[Callable]] = None
                     ) -> torch.Tensor:
    """Forward NeRFSmall -> ``[N, 4]`` (rgb logits, sigma), ``[N, 7]`` with
    the unit normal ``n / max(|n|, 1e-12)`` of the normal net, which runs in
    f32 whatever ``compute_dtype`` says (JAX mlp.py:98-103).

    A-CAQ's fake quantizers, where given (JAX mlp.py:111-140):
    ``weight_quant`` on the first sigma layer's weight, ``act_quants[l]`` on
    the activation after the ReLU of hidden sigma layer l."""
    h = input_pts
    for l, layer in enumerate(model.sigma_net):
        w = weight_quant(layer["w"]) if l == 0 and weight_quant else None
        h = _linear(layer, h, compute_dtype, w)
        if l != len(model.sigma_net) - 1:
            h = torch.relu(h)
            if act_quants is not None:
                h = act_quants[l](h)

    sigma, geo_feat = h[..., :1], h[..., 1:]
    h = geo_feat if input_views is None else torch.cat(
        [input_views, geo_feat], dim=-1)
    for l, layer in enumerate(model.color_net):
        h = _linear(layer, h, compute_dtype)
        if l != len(model.color_net) - 1:
            h = torch.relu(h)
    if not model.predict_normals:
        return torch.cat([h, sigma], dim=-1)
    n = _linear(model.normal_net[1], torch.relu(_linear(model.normal_net[0],
                                                        geo_feat)))
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-12)
    return torch.cat([h, sigma, n], dim=-1)


class NeRFBig(nn.Module):
    """The classic NeRF MLP: ``pts_linears`` (``D`` biased Linears of width
    ``W``, the encoded input concatenated back in after the ``skips``
    layers), then either the view head (``alpha_linear``,
    ``feature_linear``, ``views_linears``, ``rgb_linear``) or
    ``output_linear``.

    forward(input_pts [N, input_ch], input_views [N, input_ch_views] | None)
    -> ``[N, 4]`` (rgb logits, sigma) with the view head, else ``[N,
    output_ch]``."""

    def __init__(self, pts_linears, heads, skips=(4,)):
        super().__init__()
        self.pts_linears = nn.ModuleList(pts_linears)
        for name, layer in heads.items():
            setattr(self, name, nn.ModuleList(layer) if name == "views_linears"
                    else layer)
        self.skips = tuple(skips)

    @property
    def use_viewdirs(self) -> bool:
        return hasattr(self, "rgb_linear")

    def forward(self, input_pts: torch.Tensor,
                input_views: Optional[torch.Tensor],
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``compute_dtype`` is taken and not used: the JAX big NeRF runs in
        f32 whatever ``--precision`` says."""
        return apply_nerf_big(self, input_pts, input_views)


def init_nerf_big(generator: torch.Generator, D: int = 8, W: int = 256,
                  input_ch: int = 3, input_ch_views: int = 3,
                  output_ch: int = 4, skips: Sequence[int] = (4,),
                  use_viewdirs: bool = False, device=None) -> NeRFBig:
    """Init the classic NeRF MLP (the JAX ``init_nerf_big``'s shapes and
    distributions, torch-default Linear init)."""
    pts_linears = [init_linear(generator, input_ch, W, device=device)]
    for i in range(D - 1):
        in_dim = W + input_ch if i in skips else W
        pts_linears.append(init_linear(generator, in_dim, W, device=device))
    if use_viewdirs:
        heads = {
            "feature_linear": init_linear(generator, W, W, device=device),
            "alpha_linear": init_linear(generator, W, 1, device=device),
            "views_linears": [init_linear(generator, input_ch_views + W,
                                          W // 2, device=device)],
            "rgb_linear": init_linear(generator, W // 2, 3, device=device),
        }
    else:
        heads = {"output_linear": init_linear(generator, W, output_ch,
                                              device=device)}
    return NeRFBig(pts_linears, heads, skips)


def apply_nerf_big(model: NeRFBig, input_pts: torch.Tensor,
                   input_views: Optional[torch.Tensor]) -> torch.Tensor:
    """Forward the classic NeRF MLP (the JAX ``apply_nerf_big``)."""
    h = input_pts
    for i, layer in enumerate(model.pts_linears):
        h = torch.relu(_linear(layer, h))
        if i in model.skips:
            h = torch.cat([input_pts, h], dim=-1)
    if model.use_viewdirs:
        alpha = _linear(model.alpha_linear, h)
        feature = _linear(model.feature_linear, h)
        h = torch.cat([feature, input_views], dim=-1)
        for layer in model.views_linears:
            h = torch.relu(_linear(layer, h))
        rgb = _linear(model.rgb_linear, h)
        return torch.cat([rgb, alpha], dim=-1)
    return _linear(model.output_linear, h)
