"""Occupancy-grid guided sampling (ops/occupancy.py of the JAX package).

A dense low-resolution density grid over the scene bbox is the free
coarse pass: a ladder of candidate depths is weighted by the grid and
inverted through its CDF, so the network only sees ``n_samples`` points
per ray, concentrated on occupied space. ``occupancy_update`` is the
grid's training-time refresh; its random draws are inputs
(``draw_occupancy_update``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from indoor_nerf_tpu_torch.ops.constants import device_constant
from indoor_nerf_tpu_torch.ops.sampling import sample_pdf, stratified_z_vals

OccState = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OccupancyConfig:
    bbox_min: Tuple[float, float, float]
    bbox_max: Tuple[float, float, float]
    resolution: int = 64  # grid cells per axis
    decay: float = 0.95  # EMA decay per update round
    update_interval: int = 16  # train steps between updates
    update_fraction: float = 0.25  # fraction of cells refreshed per round
    n_candidates: int = 128  # free candidate depths per ray
    floor: float = 1e-2  # min candidate weight (keeps exploration alive)
    warmup_steps: int = 256  # uniform sampling until the grid has signal
    # "density": raw grid density; "transmittance": T*alpha of the grid
    # densities along the ladder, blended with occlusion_mix of "density"
    # pressure (ops/occupancy.py:40-62 of the JAX package says why).
    weighting: str = "density"
    occlusion_mix: float = 0.15

    @property
    def n_cells(self) -> int:
        return self.resolution**3


def init_occupancy(config: OccupancyConfig, device=None) -> OccState:
    """Start fully occupied so early sampling is uniform (nothing pruned)."""
    return {"density": torch.ones(config.n_cells, dtype=torch.float32,
                                  device=device)}


def _cell_index(pts: torch.Tensor, config: OccupancyConfig) -> torch.Tensor:
    g = config.resolution
    bmin = device_constant(config.bbox_min, torch.float32, pts.device)
    bmax = device_constant(config.bbox_max, torch.float32, pts.device)
    rel = (pts - bmin) / (bmax - bmin)
    # astype(int32) truncates toward zero, like .to(torch.int32).
    ijk = torch.clamp((rel * g).to(torch.int32), 0, g - 1).to(torch.int64)
    return (ijk[..., 0] * g + ijk[..., 1]) * g + ijk[..., 2]


def occupancy_lookup(pts: torch.Tensor, occ: OccState,
                     config: OccupancyConfig) -> torch.Tensor:
    """Nearest-cell density estimate for ``[..., 3]`` points."""
    idx = _cell_index(pts, config)
    return occ["density"][idx.reshape(-1)].reshape(idx.shape)


def draw_occupancy_update(generator: torch.Generator,
                          config: OccupancyConfig
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The refresh's draws (JAX :101-108): ``n_cells * update_fraction``
    cells, uniform with replacement (int64), and a jitter ``[m, 3]`` in
    [0, 1) per drawn cell."""
    m = int(config.n_cells * config.update_fraction)
    dev = generator.device
    cells = torch.randint(0, config.n_cells, (m,), generator=generator,
                          device=dev)
    jitter = torch.rand((m, 3), generator=generator, device=dev)
    return cells, jitter


def occupancy_update(occ: OccState,
                     sigma_fn: Callable[[torch.Tensor], torch.Tensor],
                     config: OccupancyConfig, cells: torch.Tensor,
                     jitter: torch.Tensor) -> OccState:
    """One EMA refresh round (JAX :90-117).

    The grid decays by ``config.decay``; each drawn cell is re-evaluated at
    its jittered position with ``sigma_fn(pts [m, 3]) -> [m]`` and takes
    max(decayed, fresh). A cell drawn more than once takes the largest of
    its fresh values (``scatter_reduce`` amax), where the JAX
    ``.at[cells].set`` leaves the winner unspecified: a deliberate,
    deterministic divergence (ROADMAP.md Queue 3)."""
    g = config.resolution
    dev = occ["density"].device
    ijk = torch.stack([(cells // (g * g)) % g, (cells // g) % g, cells % g],
                      dim=-1).to(torch.float32)
    bmin = device_constant(config.bbox_min, torch.float32, dev)
    bmax = device_constant(config.bbox_max, torch.float32, dev)
    pts = bmin + (ijk + jitter) / g * (bmax - bmin)
    sigma = torch.relu(sigma_fn(pts))
    decayed = occ["density"] * config.decay
    refreshed = torch.maximum(decayed[cells], sigma)
    return {"density": decayed.scatter_reduce(0, cells, refreshed, "amax")}


def occupancy_z_vals(rays_o: torch.Tensor, rays_d: torch.Tensor,
                     near: torch.Tensor, far: torch.Tensor, occ: OccState,
                     config: OccupancyConfig, n_samples: int,
                     step: Optional[int] = None,
                     t_rand: Optional[torch.Tensor] = None,
                     u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Importance-resampled depths ``[N, n_samples]`` on occupied space.

    ``step=None`` (an eval render) never applies the warmup's uniform
    weights, like the JAX ``step = 1 << 30``. ``t_rand`` ``[N, n_candidates]``
    and ``u`` ``[N, n_samples]`` are the optional jitter draws; ``None``
    gives the deterministic serving schedule."""
    warmup = step is not None and step < config.warmup_steps
    z_cand = stratified_z_vals(near, far, config.n_candidates, t_rand=t_rand)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_cand[..., :, None]
    w = occupancy_lookup(pts, occ, config)  # [N, M]

    if config.weighting == "transmittance":
        dists = z_cand[..., 1:] - z_cand[..., :-1]  # [N, M-1]
        dnorm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        tau = w[..., :-1] * dists * dnorm  # optical depth per interval
        alpha = 1.0 - torch.exp(-tau)
        trans = torch.exp(-torch.cat(
            [torch.zeros_like(tau[..., :1]), torch.cumsum(tau[..., :-1], -1)],
            -1))
        wt_vis = trans * alpha  # [N, M-1], sums to <= 1
        mix = config.occlusion_mix
        vis_sum = torch.sum(wt_vis, dim=-1, keepdim=True)
        occ_sum = torch.sum(alpha, dim=-1, keepdim=True)
        wt = (1.0 - mix) * wt_vis / torch.clamp_min(vis_sum, 1e-10) \
            + mix * alpha / torch.clamp_min(occ_sum, 1e-10)
        wt = wt + config.floor / wt.shape[-1]
        if warmup:
            wt = torch.ones_like(wt)
        return sample_pdf(z_cand, wt, n_samples, u=u)

    w = torch.clamp_min(w, config.floor)
    if warmup:
        w = torch.ones_like(w)
    z_mid = 0.5 * (z_cand[..., 1:] + z_cand[..., :-1])
    return sample_pdf(z_mid, w[..., 1:-1], n_samples, u=u)
