"""NeRFSmall (the grid encoders' network, HashNeRF-pytorch / PocketNeRF)
with its normal net, the degree-4 spherical-harmonic view encoding, and
the weights the benchmark makes for a configuration.

The weights are a flat dict keyed by the checkpoint names of the program
(``table``, ``coarse.sigma_net.0.w``, ..., ``coarse.normal_net.1.b``),
each ``[in, out]`` with ``y = x @ w``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from nerfbench.reference.spec import Spec

Params = Dict[str, torch.Tensor]

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def sh_encode(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degree 4 (16 values) of unit directions."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, _C0), -_C1 * y, _C1 * z, -_C1 * x,
        _C2[0] * xy, _C2[1] * yz, _C2[2] * (2.0 * zz - xx - yy), _C2[3] * xz,
        _C2[4] * (xx - yy),
        _C3[0] * y * (3 * xx - yy), _C3[1] * xy * z,
        _C3[2] * y * (4 * zz - xx - yy), _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        _C3[4] * x * (4 * zz - xx - yy), _C3[5] * z * (xx - yy),
        _C3[6] * x * (xx - 3 * yy)], dim=-1)


def layer_shapes(spec: Spec) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every weight of the configuration's field, in the order the
    benchmark draws them: the table, then each net's sigma, colour and
    normal layers."""
    out = [("table", spec.table_shape)]
    in_ch = spec.n_levels * spec.n_features
    h, geo = spec.hidden, spec.geo
    for net in spec.nets:
        out += [(f"{net}.sigma_net.0.w", (in_ch, h)),
                (f"{net}.sigma_net.1.w", (h, 1 + geo)),
                (f"{net}.color_net.0.w", (16 + geo, h)),
                (f"{net}.color_net.1.w", (h, h)),
                (f"{net}.color_net.2.w", (h, 3))]
        if spec.normals:
            out += [(f"{net}.normal_net.0.w", (geo, h // 2)),
                    (f"{net}.normal_net.0.b", (h // 2,)),
                    (f"{net}.normal_net.1.w", (h // 2, 3)),
                    (f"{net}.normal_net.1.b", (3,))]
    return out


def make_params(spec: Spec, seed: int, device, table_scale: float) -> Params:
    """The benchmark's weights from ``seed``: one generator on ``device``,
    one uniform draw for the table, U(-table_scale, table_scale), and one
    for all the layers together, each layer U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) (PyTorch's Linear default; a bias takes its layer's
    fan-in)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    shapes = layer_shapes(spec)
    table = torch.rand(shapes[0][1], generator=gen, device=device)
    params = {"table": table.mul_(2 * table_scale).sub_(table_scale)}
    sizes = [int(torch.tensor(s).prod()) for _, s in shapes[1:]]
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    fan_in = {}
    for name, shape in shapes[1:]:
        if name.endswith(".w"):
            fan_in[name[:-2]] = shape[0]
    off = 0
    for (name, shape), n in zip(shapes[1:], sizes):
        bound = 1.0 / float(fan_in[name[:-2]]) ** 0.5
        params[name] = (flat[off:off + n] * (2 * bound) - bound).view(shape)
        off += n
    return params


class _RoundTF32(torch.autograd.Function):
    """float32 rounded to nearest (ties to even) at TF32's 10 mantissa
    bits; the gradient passes through, as a TF32 product's does."""

    @staticmethod
    def forward(ctx, x):
        b = x.contiguous().view(torch.int32)
        b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
        return b.view(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g


def _mm(a: torch.Tensor, b: torch.Tensor, spec: Spec) -> torch.Tensor:
    if spec.tf32:
        a, b = _RoundTF32.apply(a), _RoundTF32.apply(b)
    return a @ b


def field(params: Params, net: str, feats: torch.Tensor,
          views: torch.Tensor, spec: Spec) -> torch.Tensor:
    """NeRFSmall on ``[N, L*F]`` features and ``[N, 16]`` view features:
    ``[N, 4]`` (rgb logits, sigma) or ``[N, 7]`` with the unit normal of
    the normal net. Bias-free sigma and colour layers, ReLU between them."""
    p = lambda k: params[f"{net}.{k}"]  # noqa: E731
    h = _mm(torch.relu(_mm(feats, p("sigma_net.0.w"), spec)),
            p("sigma_net.1.w"), spec)
    sigma, geo = h[:, :1], h[:, 1:]
    c = torch.cat([views, geo], dim=-1)
    c = torch.relu(_mm(c, p("color_net.0.w"), spec))
    c = torch.relu(_mm(c, p("color_net.1.w"), spec))
    rgb = _mm(c, p("color_net.2.w"), spec)
    if not spec.normals:
        return torch.cat([rgb, sigma], dim=-1)
    n = torch.relu(_mm(geo, p("normal_net.0.w"), spec) + p("normal_net.0.b"))
    n = _mm(n, p("normal_net.1.w"), spec) + p("normal_net.1.b")
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-12)
    return torch.cat([rgb, sigma, n], dim=-1)


def sigma_only(params: Params, net: str, feats: torch.Tensor,
               spec: Spec) -> torch.Tensor:
    """The density alone ``[N]`` (the sigma net's first output)."""
    h = torch.relu(_mm(feats, params[f"{net}.sigma_net.0.w"], spec))
    return _mm(h, params[f"{net}.sigma_net.1.w"], spec)[:, 0]
