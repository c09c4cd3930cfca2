"""Samples as intervals along rays: the sampling arithmetic of the two
proposal-chain models (nerfacto: nerfstudio ``model_components/
ray_samplers.py``, Tancik et al. 2023; Mip-NeRF 360: google-research/
multinerf ``internal/stepfun.py``, ``coord.py``, ``render.py``, Barron et
al. 2022).

A ray's samples are the intervals between ``n + 1`` edges. Edges live in a
normalized spacing ``x`` in [0, 1], the affine image of a spacing function
between its values at ``near`` and ``far``:

- nerfacto's piecewise ``s(t) = t / 2`` (t < 1), ``1 - 1 / (2 t)``
  (beyond) (``spacing``, ``x_to_t``): uniform in t up to 1, uniform in
  disparity beyond; every point the fields see is its interval's midpoint
  on the unit ray, contracted into the box [-2, 2]^3 (``contract``, the
  L-infinity contraction);
- Mip-NeRF 360's reciprocal ``g(t) = 1 / t`` (``reciprocal_to_t``): each
  interval is a conical frustum of the camera ray ``o + t d`` (``d`` not
  normalized) with base radius ``r``, turned into a Gaussian
  (``conical_frustum``), pushed through the L2 contraction by its
  Jacobian (``contract_gaussian``) and featurised by the integrated
  positional encoding (``integrated_pos_enc``).

The PDF samplers, the interlevel and the distortion losses read the edges
in x; the fields read depths in t. nerfacto draws new edges from a
histogram (``pdf_edges``), Mip-NeRF 360 draws interval centres and takes
their midpoints as edges (``sample_intervals``).

Random draws are inputs, as in ``ops/sampling.py``: one jitter per ray for
the initial edges (``t_rand`` ``[N, 1]``), one per ray for each PDF round
(a column of ``u``); ``None`` is the evaluation schedule.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def interval_weights(density: torch.Tensor, deltas: torch.Tensor,
                     opaque_last: bool = False) -> torch.Tensor:
    """Compositing weights ``[N, S]`` of intervals of lengths ``deltas`` at
    densities ``density``: ``alpha_i = 1 - exp(-sigma_i delta_i)`` times the
    transmittance ``exp(-sum_{j<i} sigma_j delta_j)``. No interval is
    stretched to infinity (the weights sum to at most 1), unless
    ``opaque_last``: the last interval's ``sigma delta`` is then infinite
    (multinerf's ``opaque_background``), its alpha 1 and the weights' sum
    1."""
    dd = deltas * density
    if opaque_last:
        dd = torch.cat([dd[..., :-1], torch.full_like(dd[..., -1:], math.inf)],
                       dim=-1)
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


# ---- Mip-NeRF 360 (multinerf internal/stepfun.py, coord.py, render.py) ----

# float32's machine epsilon: multinerf's guard on every division below.
EPS32 = float(torch.finfo(torch.float32).eps)
# multinerf's Model.resample_padding: added to a weight before its log.
RESAMPLE_PADDING = 0.0


def reciprocal_to_t(s: torch.Tensor, near: torch.Tensor, far: torch.Tensor
                    ) -> torch.Tensor:
    """Depths of normalized spacings ``s`` ``[N, K]`` under ``g(t) = 1 /
    t``: ``1 / (s / far + (1 - s) / near)`` (``near``, ``far`` ``[N,
    1]``)."""
    return 1.0 / (s * (1.0 / far) + (1.0 - s) * (1.0 / near))


def sorted_interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
                  ) -> torch.Tensor:
    """multinerf's ``math.sorted_interp``: ``fp`` at ``x`` ``[N, M]`` by
    linear interpolation in the ascending ``xp`` ``[N, K]`` (``searchsorted``
    to the right, the offset clipped to [0, 1], its denominator at least
    ``EPS32^2``)."""
    idx = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
    i0 = torch.clamp_min(idx - 1, 0)
    i1 = torch.clamp_max(idx, xp.shape[-1] - 1)
    xp0, xp1 = torch.gather(xp, -1, i0), torch.gather(xp, -1, i1)
    fp0, fp1 = torch.gather(fp, -1, i0), torch.gather(fp, -1, i1)
    offset = torch.clip((x - xp0) / torch.clamp_min(xp1 - xp0, EPS32 ** 2),
                        0.0, 1.0)
    return fp0 + offset * (fp1 - fp0)


def sample_intervals(edges: torch.Tensor, weights: torch.Tensor, n: int,
                     u: Optional[torch.Tensor]) -> torch.Tensor:
    """``n`` new intervals (``n + 1`` edges ``[N, n + 1]`` in [0, 1]) drawn
    from the step function ``weights`` ``[N, S]`` on ``edges`` ``[N, S +
    1]`` (multinerf ``stepfun.sample_intervals`` with one jitter a ray):
    the histogram ``softmax(log(w + RESAMPLE_PADDING))`` over the
    non-empty intervals, ``n`` centres at its inverse CDF of ``linspace(0,
    1 - u_max, n)`` plus ``u`` ``[N, 1]`` in [0, 1) times the largest
    jitter (training), or of ``(k + 1/2) / n`` (``u`` None); the edges are
    the centres' midpoints, the end ones the first and last centre's
    reflections of their midpoint, clamped to [0, 1]. No gradient flows
    through the result."""
    e = edges.detach()
    logits = torch.where(e[..., 1:] > e[..., :-1],
                         torch.log(weights.detach() + RESAMPLE_PADDING),
                         -math.inf)
    w = torch.softmax(logits, dim=-1)
    cw = torch.clamp_max(torch.cumsum(w[..., :-1], dim=-1), 1.0)
    zero = w.new_zeros(w.shape[:-1] + (1,))
    cw = torch.cat([zero, cw, zero + 1.0], dim=-1)
    dev = e.device
    if u is None:
        grid = (torch.arange(n, device=dev, dtype=torch.float32) + 0.5) / n
        draws = grid.expand(e.shape[0], n)
    else:
        u_max = EPS32 + (1.0 - EPS32) / n
        max_jitter = (1.0 - u_max) / (n - 1) - EPS32
        grid = torch.linspace(0.0, 1.0 - u_max, n, device=dev)
        draws = grid + u * max_jitter
    centers = sorted_interp(draws, cw, e)
    mid = 0.5 * (centers[..., 1:] + centers[..., :-1])
    first = torch.clamp_min(2.0 * centers[..., :1] - mid[..., :1], 0.0)
    last = torch.clamp_max(2.0 * centers[..., -1:] - mid[..., -1:], 1.0)
    return torch.cat([first, mid, last], dim=-1)


def conical_frustum(rays_o: torch.Tensor, rays_d: torch.Tensor,
                    t: torch.Tensor, radius: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Gaussians of the conical frustums between depths ``t`` ``[N, S
    + 1]`` of rays ``o + t d`` (``[N, 3]`` each) of base radius ``radius``
    (mip-NeRF eq. 7): ``(mean [N, S, 3], t_var [N, S], r_var [N, S])``,
    the covariance being ``t_var d d^T + r_var (I - d d^T / |d|^2)``."""
    t0, t1 = t[..., :-1], t[..., 1:]
    mu = 0.5 * (t0 + t1)
    hw = 0.5 * (t1 - t0)
    hw2 = hw * hw
    denom = torch.clamp_min(3.0 * mu * mu + hw2, EPS32)
    t_mean = mu + 2.0 * mu * hw2 / denom
    t_var = hw2 / 3.0 - (4.0 / 15.0) * hw2 * hw2 * (12.0 * mu * mu - hw2) \
        / (denom * denom)
    r_var = (mu * mu / 4.0 + (5.0 / 12.0) * hw2
             - (4.0 / 15.0) * hw2 * hw2 / denom) * (radius * radius)
    mean = rays_o[:, None, :] + rays_d[:, None, :] * t_mean[..., None]
    return mean, t_var, r_var


def contract_l2(x: torch.Tensor) -> torch.Tensor:
    """Mip-NeRF 360's contraction of ``[..., 3]`` points: ``x`` where
    ``|x| <= 1``, else ``(2 - 1 / |x|) x / |x|`` (multinerf's squared norm
    clamped to ``EPS32``)."""
    r2 = torch.clamp_min(torch.sum(x * x, dim=-1, keepdim=True), EPS32)
    r = torch.sqrt(r2)
    return torch.where(r2 <= 1.0, x, (2.0 * r - 1.0) / r2 * x)


def contract_gaussian(mean: torch.Tensor, rays_d: torch.Tensor,
                      t_var: torch.Tensor, r_var: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(contract(mean), diag(J S J^T))`` of the frustums' Gaussians
    ``[N, S, 3]`` (``conical_frustum``'s), ``J`` the contraction's Jacobian
    at the mean: ``(2/r - 1/r^2) I - (2/r^3)(1 - 1/r) x x^T`` beyond ``r =
    |x| = 1``, ``I`` inside. With ``S = r_var I + c d d^T``, ``c = t_var -
    r_var / |d|^2``, and ``J = a I + b x x^T`` the diagonal is ``a^2 S_kk +
    2 a b x_k (S x)_k + b^2 x_k^2 x^T S x``, every term elementwise."""
    d = rays_d[:, None, :]
    d2 = torch.clamp_min(torch.sum(d * d, dim=-1), EPS32)  # [N, 1]
    c = t_var - r_var / d2
    diag = r_var[..., None] + c[..., None] * d * d
    r2 = torch.clamp_min(torch.sum(mean * mean, dim=-1), EPS32)
    r = torch.sqrt(r2)
    inside = r2 <= 1.0
    rs = torch.where(inside, 1.0, r)
    a = 2.0 / rs - 1.0 / (rs * rs)
    b = -2.0 / (rs * rs * rs) * (1.0 - 1.0 / rs)
    dx = torch.sum(d * mean, dim=-1)
    sx = r_var[..., None] * mean + (c * dx)[..., None] * d
    xsx = r_var * r2 + c * dx * dx
    out = (a * a)[..., None] * diag + (2.0 * a * b)[..., None] * mean * sx \
        + (b * b * xsx)[..., None] * mean * mean
    return contract_l2(mean), torch.where(inside[..., None], diag, out)


def integrated_pos_enc(mean: torch.Tensor, var: torch.Tensor,
                       n_degrees: int) -> torch.Tensor:
    """The integrated positional encoding ``[..., 6 L]`` of Gaussians of
    means and axis variances ``[..., 3]``: ``[sin(2^l m) exp(-4^l v / 2),
    cos(2^l m) exp(-4^l v / 2)]`` for ``l < n_degrees``, the sines of
    every degree first (degree-major, then x, y, z), then the cosines."""
    scales = 2.0 ** torch.arange(n_degrees, dtype=torch.float32,
                                 device=mean.device)
    shape = mean.shape[:-1] + (-1,)
    sm = (mean[..., None, :] * scales[:, None]).reshape(shape)
    sv = (var[..., None, :] * (scales * scales)[:, None]).reshape(shape)
    damp = torch.exp(-0.5 * sv)
    return torch.cat([torch.sin(sm) * damp, torch.cos(sm) * damp], dim=-1)


def pos_enc(x: torch.Tensor, n_degrees: int) -> torch.Tensor:
    """multinerf's ``pos_enc`` with the identity: ``[x, sin(2^l x),
    cos(2^l x)]`` for ``l < n_degrees``, degree-major as
    ``integrated_pos_enc`` (``3 + 6 L`` features of a direction)."""
    scales = 2.0 ** torch.arange(n_degrees, dtype=torch.float32,
                                 device=x.device)
    sx = (x[..., None, :] * scales[:, None]).reshape(x.shape[:-1] + (-1,))
    return torch.cat([x, torch.sin(sx), torch.cos(sx)], dim=-1)
