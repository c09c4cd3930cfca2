"""Sampling along rays, alpha compositing and the occupancy grid.

Two samplers, as the configurations state them:

- occupancy-guided (NerfAcc-style): a ladder of ``occ_candidates``
  stratified depths is weighted by a dense ``occ_resolution``^3 density
  grid (by the grid's transmittance T * alpha mixed with ``occ_mix`` of its
  opacity, plus a floor), and ``occ_samples`` depths are drawn through the
  inverse CDF; uniform weights during the grid's warm-up steps;
- hierarchical (NeRF): ``n_samples`` stratified coarse depths, then
  ``n_importance`` more from the coarse weights' inverse CDF, and the fine
  net on all of them, sorted.

Random draws are inputs (``t_rand`` stratum jitter, ``u`` sorted inverse-CDF
draws); a test-mode render takes none.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from nerfbench.reference import grid, model
from nerfbench.reference.spec import FAR, NEAR, Spec


def linspace01(n: int, device) -> torch.Tensor:
    """``i * f32(1 / (n - 1))`` with the last point exactly 1."""
    t = torch.arange(n, dtype=torch.float32, device=device)
    t = t * float(np.float32(1.0 / (n - 1)))
    t[-1] = 1.0
    return t


def stratified(near: torch.Tensor, far: torch.Tensor, n: int,
               t_rand: Optional[torch.Tensor]) -> torch.Tensor:
    t = linspace01(n, near.device)
    z = (near * (1.0 - t) + far * t).expand(near.shape[0], n)
    if t_rand is not None:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], -1)
        lower = torch.cat([z[..., :1], mids], -1)
        z = lower + (upper - lower) * t_rand
    return z


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n: int,
               u: Optional[torch.Tensor]) -> torch.Tensor:
    """Inverse-CDF samples of the piecewise-constant pdf ``weights`` (plus
    1e-5) over ``bins``; ``u`` None: the deterministic linspace."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, -1)], -1)
    if u is None:
        u = linspace01(n, cdf.device).expand(cdf.shape[0], n)
    u = u.contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, cdf.shape[-1] - 1)
    cdf_b, cdf_a = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_b, bins_a = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


def occ_cell(pts: torch.Tensor, spec: Spec) -> torch.Tensor:
    g = spec.occ_resolution
    lo = torch.tensor(spec.bbox_min, dtype=torch.float32, device=pts.device)
    hi = torch.tensor(spec.bbox_max, dtype=torch.float32, device=pts.device)
    ijk = torch.clamp(((pts - lo) / (hi - lo) * g).to(torch.int32), 0, g - 1)
    ijk = ijk.to(torch.int64)
    return (ijk[..., 0] * g + ijk[..., 1]) * g + ijk[..., 2]


def occupancy_z(rays_o, rays_d, near, far, density: torch.Tensor, spec: Spec,
                warmup: bool, t_rand=None, u=None) -> torch.Tensor:
    z = stratified(near, far, spec.occ_candidates, t_rand)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., :, None]
    w = density[occ_cell(pts, spec).reshape(-1)].reshape(z.shape)
    if not spec.occ_transmittance:
        w = torch.clamp_min(w, spec.occ_floor)
        if warmup:
            w = torch.ones_like(w)
        zm = 0.5 * (z[..., 1:] + z[..., :-1])
        return sample_pdf(zm, w[..., 1:-1], spec.occ_samples, u)
    tau = w[..., :-1] * (z[..., 1:] - z[..., :-1]) \
        * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-tau)
    trans = torch.exp(-torch.cat([torch.zeros_like(tau[..., :1]),
                                  torch.cumsum(tau[..., :-1], -1)], -1))
    vis = trans * alpha
    mix = spec.occ_mix
    wt = (1.0 - mix) * vis / torch.clamp_min(vis.sum(-1, keepdim=True), 1e-10) \
        + mix * alpha / torch.clamp_min(alpha.sum(-1, keepdim=True), 1e-10)
    wt = wt + spec.occ_floor / wt.shape[-1]
    if warmup:
        wt = torch.ones_like(wt)
    return sample_pdf(z, wt, spec.occ_samples, u)


def composite(raw: torch.Tensor, z: torch.Tensor, rays_d: torch.Tensor,
              spec: Spec) -> Dict[str, torch.Tensor]:
    """Volume rendering of raw ``[N, S, 4 or 7]``: rgb, depth, acc maps,
    the weights, the entropy of the per-ray weights with a background
    state, and with normals the soft-normalised normal map."""
    dists = z[..., 1:] - z[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)
    rgb = torch.sigmoid(raw[..., :3])
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[..., :-1]
    weights = alpha * trans
    acc = weights.sum(-1)
    out = {"rgb_map": (weights[..., None] * rgb).sum(-2), "acc_map": acc,
           "weights": weights,
           "depth_map": (weights * z).sum(-1) / torch.clamp_min(acc, 1e-10)}
    if spec.white_bkgd:
        out["rgb_map"] = out["rgb_map"] + (1.0 - acc[..., None])
    probs = torch.cat([weights, torch.clamp_min(1.0 - acc[..., None], 1e-6)], -1)
    probs = probs / probs.sum(-1, keepdim=True)
    out["sparsity"] = -(probs * torch.log(torch.clamp_min(probs, 1e-30))).sum(-1)
    if raw.shape[-1] >= 7:
        nm = (weights[..., None] * raw[..., 4:7]).sum(-2)
        out["normal_map"] = nm * torch.rsqrt((nm * nm).sum(-1, keepdim=True) + 1e-6)
    return out


def query(params, net: str, pts: torch.Tensor, viewdirs: torch.Tensor,
          spec: Spec) -> torch.Tensor:
    r, s, _ = pts.shape
    feats, keep = grid.encode(pts.reshape(-1, 3), params["table"], spec)
    views = model.sh_encode(viewdirs)[:, None, :].expand(r, s, 16).reshape(r * s, 16)
    raw = model.field(params, net, feats, views, spec)
    sigma = torch.where(keep, raw[:, 3], 0.0)
    raw = torch.cat([raw[:, :3], sigma[:, None], raw[:, 4:]], -1)
    return raw.reshape(r, s, -1)


def render_rays(params, rays_o, rays_d, spec: Spec,
                density: Optional[torch.Tensor], step: Optional[int],
                draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """Render ``[N]`` rays (training with ``draws``, or test mode without);
    viewdirs are the unit ray directions, near/far the scene's."""
    draws = draws or {}
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    near = NEAR * torch.ones_like(rays_d[..., :1])
    far = FAR * torch.ones_like(rays_d[..., :1])
    if spec.occupancy:
        warmup = step is not None and step < spec.occ_warmup
        z = occupancy_z(rays_o, rays_d, near, far, density, spec, warmup,
                        draws.get("t_rand"), draws.get("u"))
        net = spec.nets[-1]
    else:
        z = stratified(near, far, spec.n_samples, draws.get("t_rand"))
        net = "coarse"
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., :, None]
    out = composite(query(params, net, pts, viewdirs, spec), z, rays_d, spec)
    if not spec.occupancy and spec.n_importance > 0:
        coarse = out
        zm = 0.5 * (z[..., 1:] + z[..., :-1])
        zs = sample_pdf(zm, coarse["weights"][..., 1:-1], spec.n_importance,
                        draws.get("u")).detach()
        z = torch.sort(torch.cat([z, zs], -1), -1).values
        pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., :, None]
        out = composite(query(params, "fine", pts, viewdirs, spec), z, rays_d,
                        spec)
        out["rgb0"], out["sparsity0"] = coarse["rgb_map"], coarse["sparsity"]
    return out


def occupancy_refresh(density: torch.Tensor, params, spec: Spec,
                      cells: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    """One refresh round: the grid decays by 0.95 and each drawn cell takes
    the larger of its decayed value and the field's density (ReLU, zero
    outside the box) at its jittered position (a cell drawn twice: the
    largest)."""
    g = spec.occ_resolution
    lo = torch.tensor(spec.bbox_min, dtype=torch.float32, device=density.device)
    hi = torch.tensor(spec.bbox_max, dtype=torch.float32, device=density.device)
    ijk = torch.stack([(cells // (g * g)) % g, (cells // g) % g, cells % g],
                      -1).to(torch.float32)
    pts = lo + (ijk + jitter) / g * (hi - lo)
    with torch.no_grad():
        feats, keep = grid.encode(pts, params["table"], spec)
        sigma = torch.relu(torch.where(
            keep, model.sigma_only(params, spec.nets[-1], feats, spec), 0.0))
    decayed = density * spec.occ_decay
    fresh = torch.maximum(decayed[cells], sigma)
    return decayed.scatter_reduce(0, cells, fresh, "amax")


def image_rays(H: int, W: int, focal: float, c2w: torch.Tensor):
    """Flat rays ``[H * W, 3]`` of a pinhole camera with the principal
    point at the centre, in row-major pixel order."""
    dev = c2w.device
    i, j = torch.meshgrid(torch.arange(W, dtype=torch.float32, device=dev),
                          torch.arange(H, dtype=torch.float32, device=dev),
                          indexing="xy")
    K = torch.tensor([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                     dtype=torch.float32, device=dev)
    dirs = torch.stack([(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1],
                        -torch.ones_like(i)], -1)
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], -1).reshape(-1, 3)
    return c2w[:3, -1].expand(rays_d.shape), rays_d


@torch.no_grad()
def render_image(params, c2w: torch.Tensor, H: int, W: int, focal: float,
                 density: torch.Tensor, spec: Spec, block_rays: int = 8192
                 ) -> Dict[str, torch.Tensor]:
    """rgb ``[H, W, 3]`` and depth ``[H, W]`` of a test-mode render, in
    blocks of ``block_rays`` rays."""
    ro, rd = image_rays(H, W, focal, c2w)
    maps = {"rgb_map": [], "depth_map": []}
    for s in range(0, ro.shape[0], block_rays):
        out = render_rays(params, ro[s:s + block_rays], rd[s:s + block_rays],
                          spec, density, None)
        for k in maps:
            maps[k].append(out[k])
    return {"rgb": torch.cat(maps["rgb_map"]).reshape(H, W, 3),
            "depth": torch.cat(maps["depth_map"]).reshape(H, W)}


@torch.no_grad()
def sample_points(params, rays_o, rays_d, spec: Spec,
                  density: Optional[torch.Tensor], step: Optional[int],
                  draws: Optional[Dict[str, torch.Tensor]] = None):
    """The points every pass of a render queries, one ``[N * S, 3]``
    tensor per pass (the encode's inputs)."""
    draws = draws or {}
    near = NEAR * torch.ones_like(rays_d[..., :1])
    far = FAR * torch.ones_like(rays_d[..., :1])
    if spec.occupancy:
        warmup = step is not None and step < spec.occ_warmup
        z = occupancy_z(rays_o, rays_d, near, far, density, spec, warmup,
                        draws.get("t_rand"), draws.get("u"))
    else:
        z = stratified(near, far, spec.n_samples, draws.get("t_rand"))
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., :, None]
    out = [pts.reshape(-1, 3)]
    if not spec.occupancy and spec.n_importance > 0:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        coarse = composite(query(params, "coarse", pts, viewdirs, spec), z,
                           rays_d, spec)
        zm = 0.5 * (z[..., 1:] + z[..., :-1])
        zs = sample_pdf(zm, coarse["weights"][..., 1:-1], spec.n_importance,
                        draws.get("u"))
        z = torch.sort(torch.cat([z, zs], -1), -1).values
        out.append((rays_o[..., None, :] + rays_d[..., None, :]
                    * z[..., :, None]).reshape(-1, 3))
    return out
