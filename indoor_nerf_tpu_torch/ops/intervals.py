"""Samples as intervals along unit rays: nerfacto's sampling arithmetic
(nerfstudio ``model_components/ray_samplers.py``, Tancik et al. 2023;
Mip-NeRF 360, Barron et al. 2022).

A ray's samples are the intervals between ``n + 1`` edges. Edges live in a
normalized spacing ``x`` in [0, 1], the affine image of the piecewise
spacing ``s(t) = t / 2`` (t < 1), ``1 - 1 / (2 t)`` (beyond) between
``s(near)`` and ``s(far)``: uniform in t up to 1, uniform in disparity
beyond. The PDF sampler, the interlevel and the distortion losses read the
edges in x; the field reads the intervals' midpoints in t. Every point
the fields see is first contracted into the box [-2, 2]^3 (``contract``,
the L-infinity contraction).

Random draws are inputs, as in ``ops/sampling.py``: one jitter per ray for
the initial edges (``t_rand`` ``[N, 1]``), one per ray for each PDF round
(a column of ``u``); ``None`` is the evaluation schedule.
"""

from __future__ import annotations

from typing import Optional

import torch

# The contracted scene's box: contract() maps R^3 into its interior.
CONTRACTED_MIN = (-2.0, -2.0, -2.0)
CONTRACTED_MAX = (2.0, 2.0, 2.0)
HISTOGRAM_PADDING = 0.01  # added to every weight before a PDF draw
PDF_EPS = 1e-5  # the least total weight of a PDF draw


def contract(x: torch.Tensor) -> torch.Tensor:
    """The L-infinity scene contraction of ``[..., 3]`` points: ``x`` where
    ``|x|_inf <= 1``, else ``(2 - 1 / |x|_inf) x / |x|_inf``."""
    mag = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    safe = torch.clamp_min(mag, 1.0)
    return torch.where(mag <= 1.0, x, (2.0 - 1.0 / safe) * (x / safe))


def spacing(t: torch.Tensor) -> torch.Tensor:
    """``s(t)``: ``t / 2`` below 1, ``1 - 1 / (2 t)`` from 1 on."""
    return torch.where(t < 1.0, t / 2.0, 1.0 - 1.0 / (2.0 * t))


def spacing_inv(s: torch.Tensor) -> torch.Tensor:
    """``t(s)``: ``2 s`` below 1/2, ``1 / (2 - 2 s)`` from 1/2 on."""
    return torch.where(s < 0.5, 2.0 * s, 1.0 / (2.0 - 2.0 * s))


def x_to_t(x: torch.Tensor, near: torch.Tensor, far: torch.Tensor
           ) -> torch.Tensor:
    """Depths of normalized spacings ``x`` ``[N, K]`` on rays with bounds
    ``near``, ``far`` ``[N, 1]``."""
    s_near, s_far = spacing(near), spacing(far)
    return spacing_inv(x * s_far + (1.0 - x) * s_near)


def initial_edges(n_rays: int, n: int, t_rand: Optional[torch.Tensor],
                  device=None) -> torch.Tensor:
    """The ``n + 1`` initial edges ``[N, n + 1]`` in x: uniform, and with
    ``t_rand`` ``[N, 1]`` each moved within its stratum by the ray's one
    draw (nerfstudio's ``SpacedSampler`` with a single jitter: the interior
    edges by ``(u - 1/2) / n``, the end edges by half that toward the
    inside)."""
    bins = torch.linspace(0.0, 1.0, n + 1, device=device)[None, :]
    if t_rand is None:
        return bins.expand(n_rays, n + 1)
    centers = (bins[..., 1:] + bins[..., :-1]) / 2.0
    upper = torch.cat([centers, bins[..., -1:]], -1)
    lower = torch.cat([bins[..., :1], centers], -1)
    return lower + (upper - lower) * t_rand


def interval_weights(density: torch.Tensor, deltas: torch.Tensor
                     ) -> torch.Tensor:
    """Compositing weights ``[N, S]`` of intervals of lengths ``deltas`` at
    densities ``density``: ``alpha_i = 1 - exp(-sigma_i delta_i)`` times the
    transmittance ``exp(-sum_{j<i} sigma_j delta_j)``. No interval is
    stretched to infinity: the weights sum to at most 1."""
    dd = deltas * density
    alphas = 1.0 - torch.exp(-dd)
    trans = torch.cumsum(dd[..., :-1], dim=-1)
    trans = torch.cat([torch.zeros_like(dd[..., :1]), trans], dim=-1)
    return torch.nan_to_num(alphas * torch.exp(-trans))


def pdf_edges(edges: torch.Tensor, weights: torch.Tensor, n: int,
              u: Optional[torch.Tensor], anneal: float = 1.0) -> torch.Tensor:
    """``n + 1`` new edges ``[N, n + 1]`` in x drawn from the histogram of
    ``weights`` ``[N, S]`` over ``edges`` ``[N, S + 1]`` (nerfstudio's
    ``PDFSampler``): the weights raised to ``anneal``, padded by 0.01 each
    and to a total of at least 1e-5, the CDF capped at 1; the draws at
    ``k / (n + 1)`` plus the ray's ``u`` ``[N, 1]`` in [0, 1) over ``n +
    1`` (training) or plus ``1 / (2 (n + 1))`` (``u`` None); each edge the
    linear interpolation of the bracketing edges, clamped. No gradient
    flows through the result."""
    w = weights.detach()
    if anneal != 1.0:
        w = torch.pow(w, anneal)
    w = w + HISTOGRAM_PADDING
    total = torch.sum(w, dim=-1, keepdim=True)
    pad = torch.relu(PDF_EPS - total)
    w = w + pad / w.shape[-1]
    total = total + pad
    pdf = w / total
    cdf = torch.clamp_max(torch.cumsum(pdf, dim=-1), 1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    bins = n + 1
    grid = torch.linspace(0.0, 1.0 - 1.0 / bins, bins, device=cdf.device)
    if u is None:
        draws = (grid + 1.0 / (2 * bins)).expand(cdf.shape[0], bins)
    else:
        draws = grid + u / bins
    draws = draws.contiguous()
    e = edges.detach()
    last = e.shape[-1] - 1
    inds = torch.searchsorted(cdf, draws, right=True)
    below = torch.clamp(inds - 1, 0, last)
    above = torch.clamp(inds, 0, last)
    cdf0, cdf1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    e0, e1 = torch.gather(e, -1, below), torch.gather(e, -1, above)
    t = torch.clip(torch.nan_to_num((draws - cdf0) / (cdf1 - cdf0), 0.0),
                   0.0, 1.0)
    return e0 + t * (e1 - e0)
