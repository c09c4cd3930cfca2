"""Occupancy-grid guided sampling (ops/occupancy.py of the JAX package).

A dense low-resolution density grid over the scene bbox is the free
coarse pass: a ladder of candidate depths is weighted by the grid and
inverted through its CDF, so the network only sees ``n_samples`` points
per ray, concentrated on occupied space. ``occupancy_update`` is the
grid's training-time refresh; its random draws are inputs
(``draw_occupancy_update``).

Two implementations of the sampler live here:

- ``occupancy_z_vals_plain``: the eager chain (the candidate ladder, the
  grid lookup, the weights, ``sample_pdf``). The reference the kernel is
  held against, on the CPU and on the card.
- the kernel (``csrc/occ_sample.cu``), through ``occ_sample``: one warp a
  ray, float32 in the eager chain's order, one launch a call.

``occupancy_z_vals`` takes the plain chain for CPU tensors and the kernel
for CUDA tensors, or raises where the kernel refuses its inputs (more
candidates or samples than ``MAX_CANDIDATES``/``MAX_SAMPLES``, a dtype
other than float32): there is no fallback to the plain chain on the card.
Strided inputs, which the plain chain takes as they come (a step's patch
rays are such), reach the kernel as contiguous copies; ``occ_sample``
itself refuses them. The choice rests on the device alone; the kernel's
behaviour on the config's fields and the presence of the draws.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from indoor_nerf_tpu_torch.cuda_build import count, launch_on_stream, load_library
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


def _in_warmup(config: OccupancyConfig, step: Optional[int]) -> bool:
    return step is not None and step < config.warmup_steps


def occupancy_z_vals(rays_o: torch.Tensor, rays_d: torch.Tensor,
                     near: torch.Tensor, far: torch.Tensor, occ: OccState,
                     config: OccupancyConfig, n_samples: int,
                     step: Optional[int] = None,
                     t_rand: Optional[torch.Tensor] = None,
                     u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Importance-resampled depths ``[N, n_samples]`` on occupied space:
    ``occupancy_z_vals_plain`` on the CPU; on a CUDA device the kernel
    (``occ_sample``), one launch on the current stream, or a raise.

    ``step=None`` (an eval render) never applies the warmup's uniform
    weights, like the JAX ``step = 1 << 30``. ``t_rand`` ``[N, n_candidates]``
    and ``u`` ``[N, n_samples]`` are the optional jitter draws; ``None``
    gives the deterministic serving schedule."""
    if rays_o.device.type == "cpu":
        return occupancy_z_vals_plain(rays_o, rays_d, near, far, occ, config,
                                      n_samples, step, t_rand, u)
    t_rand, u = (None if t is None else t.contiguous() for t in (t_rand, u))
    return occ_sample(rays_o.contiguous(), rays_d.contiguous(),
                      near.contiguous(), far.contiguous(),
                      occ["density"].contiguous(), config, n_samples,
                      _in_warmup(config, step), t_rand, u)


def occupancy_z_vals_plain(rays_o: torch.Tensor, rays_d: torch.Tensor,
                           near: torch.Tensor, far: torch.Tensor,
                           occ: OccState, config: OccupancyConfig,
                           n_samples: int, step: Optional[int] = None,
                           t_rand: Optional[torch.Tensor] = None,
                           u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``occupancy_z_vals`` as eager tensor code (the JAX package's op
    order), on any device."""
    z_cand, w = candidate_densities(rays_o, rays_d, near, far, occ, config,
                                    t_rand)
    return resample(z_cand, w, rays_d, config, n_samples,
                    _in_warmup(config, step), u)


def candidate_densities(rays_o: torch.Tensor, rays_d: torch.Tensor,
                        near: torch.Tensor, far: torch.Tensor, occ: OccState,
                        config: OccupancyConfig,
                        t_rand: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain chain's first half: the candidate depths ``[N, M]`` and
    their cells' densities ``[N, M]``."""
    z_cand = stratified_z_vals(near, far, config.n_candidates, t_rand=t_rand)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_cand[..., :, None]
    return z_cand, occupancy_lookup(pts, occ, config)


def resample(z_cand: torch.Tensor, w: torch.Tensor, rays_d: torch.Tensor,
             config: OccupancyConfig, n_samples: int, warmup: bool,
             u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain chain's second half: the candidates' weights under
    ``config.weighting`` and the inverse-CDF samples ``[N, n_samples]``, in
    the inputs' dtype."""
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


# The kernel's caps (csrc/occ_sample.cu): a lane holds at most 4 of a ray's
# candidates, one warp a ray, so every sum over a ray's row runs in the
# order torch's CUDA reduction takes for rows under 128 entries; samples
# are taken 32 at a time by the warp.
MAX_CANDIDATES = 128
MAX_SAMPLES = 256


def _kernel_scalars(config: OccupancyConfig, n_samples: int) -> np.ndarray:
    """The kernel's float32 scalars, in the order of its ``Scalar`` enum,
    rounded as the plain chain rounds them (each Python number to float32
    where a tensor op meets it; the box's extent a float32 difference).
    Made once per set of values."""
    return _scalars(tuple(float(v) for v in config.bbox_min),
                    tuple(float(v) for v in config.bbox_max),
                    config.n_candidates, n_samples, float(config.floor),
                    config.weighting, float(config.occlusion_mix))


@functools.lru_cache(maxsize=64)
def _scalars(bbox_min, bbox_max, m, n_samples, floor, weighting, mix
             ) -> np.ndarray:
    f32 = np.float32
    bmin = np.asarray(bbox_min, f32)
    ext = np.asarray(bbox_max, f32) - bmin
    if weighting == "transmittance":
        floor = floor / (m - 1)
    out = np.array([*bmin, *ext, f32(1.0 / (m - 1)),
                    f32(1.0 / (n_samples - 1)) if n_samples > 1 else 0.0,
                    f32(floor), f32(mix), f32(1.0 - mix)], f32)
    out.setflags(write=False)
    return out


def _last_pow2(v: int) -> int:
    return 1 << (v.bit_length() - 1)


def _ceil_log2(v: int) -> int:
    return max(0, (v - 1).bit_length())


def torch_sum_width(n: int, rows: int) -> int:
    """The threads a row that torch's CUDA sum over the last dim of a
    contiguous float32 ``[rows, n]`` tensor takes, for ``n`` under 128
    (``setReduceConfig`` of aten/src/ATen/native/cuda/Reduce.cuh: 512
    threads a block, the row's threads a power of two). Thread l sums
    entries l, l + width, ... in order; the threads' sums then meet in a
    tree. Held against torch.sum on the card in
    tests/test_torch_occ_sample_cuda.py."""
    d0, d1 = _last_pow2(max(n, 1)), min(_last_pow2(max(rows, 1)), 512)
    width = min(d0, 32)
    height = min(d1, 512 // width)
    return min(d0, 512 // height)


def torch_scan_chunk(n: int, rows: int) -> int:
    """The entries a chunk of torch's CUDA cumsum over the last dim of a
    contiguous ``[rows, n]`` tensor (ScanUtils.cuh's innermost scan: twice
    its threads a row, from ``get_log_num_threads_x_inner_scan``, whose
    difference of logarithms wraps around as an unsigned 32-bit integer).
    Each chunk is a Sklansky scan after its first entry took the previous
    chunks' total."""
    diff = (_ceil_log2(n) - _ceil_log2(rows)) % (1 << 32)
    log_x = ((9 + diff) % (1 << 32)) // 2
    return 2 << min(max(4, log_x), 9)


def _kernel_orders(config: OccupancyConfig, rays: int):
    """torch's orders of the plain chain's sums over ``rays`` rays, in the
    order of the kernel's ``Order`` enum: the threads of the sums of the
    visible and the occlusion weights, of the pdf's total, and the scan
    chunks (in slots of 32 entries) of the optical depth and of the pdf."""
    m = config.n_candidates
    intervals = m - 1 if config.weighting == "transmittance" else m - 2
    return _orders(m, intervals, rays)


@functools.lru_cache(maxsize=256)
def _orders(m: int, intervals: int, rays: int):
    values = (torch_sum_width(m - 1, rays), torch_sum_width(intervals, rays),
              torch_scan_chunk(m - 2, rays) // 32,
              torch_scan_chunk(intervals, rays) // 32)
    return (ctypes.c_int * len(values))(*values)


def _check_inputs(rays_o: torch.Tensor, rays_d: torch.Tensor,
                  near: torch.Tensor, far: torch.Tensor, density: torch.Tensor,
                  config: OccupancyConfig, n_samples: int,
                  t_rand: Optional[torch.Tensor],
                  u: Optional[torch.Tensor]) -> None:
    """Raise where the kernel cannot take these inputs. Checked on any
    device; the kernel runs only on a CUDA one."""
    m, n = config.n_candidates, rays_o.shape[0]
    if config.weighting not in ("transmittance", "density"):
        raise ValueError(f"occ_sample knows no weighting {config.weighting!r}")
    least = 2 if config.weighting == "transmittance" else 3
    if not least <= m <= MAX_CANDIDATES:
        raise ValueError(f"occ_sample takes {least} to {MAX_CANDIDATES} "
                         f"candidates with {config.weighting} weighting, not "
                         f"{m}")
    if not 1 <= n_samples <= MAX_SAMPLES:
        raise ValueError(f"occ_sample takes 1 to {MAX_SAMPLES} samples a ray, "
                         f"not {n_samples}")
    tensors = {"rays_o": (rays_o, (n, 3)), "rays_d": (rays_d, (n, 3)),
               "near": (near, (n, 1)), "far": (far, (n, 1)),
               "density": (density, (config.n_cells,)),
               "t_rand": (t_rand, (n, m)), "u": (u, (n, n_samples))}
    for name, (t, shape) in tensors.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"occ_sample takes {name} as torch.float32, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"occ_sample takes {name} of shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"occ_sample takes {name} contiguous")
        if t.device != rays_o.device:
            raise ValueError(f"occ_sample takes every input on "
                             f"{rays_o.device}; {name} is on {t.device}")
    if rays_o.device.type != "cuda":
        raise ValueError("occ_sample runs on a CUDA device; occupancy_z_vals "
                         "takes the plain chain on the CPU")


def occ_sample(rays_o: torch.Tensor, rays_d: torch.Tensor, near: torch.Tensor,
               far: torch.Tensor, density: torch.Tensor,
               config: OccupancyConfig, n_samples: int, warmup: bool,
               t_rand: Optional[torch.Tensor] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``occupancy_z_vals_plain``'s ``[N, n_samples]`` depths through the
    kernel: one launch on the current stream, without a synchronize, or a
    raise. ``warmup``: the uniform weights of the grid's warm-up steps.
    Counts ``occ_sample`` (launches) and ``occ_sample.rays``."""
    _check_inputs(rays_o, rays_d, near, far, density, config, n_samples,
                  t_rand, u)
    n = rays_o.shape[0]
    z = torch.empty((n, n_samples), dtype=torch.float32, device=rays_o.device)
    if n == 0:
        return z
    lib = load_library("occ_sample", _check_caps).lib
    scalars = _kernel_scalars(config, n_samples)
    none = z.new_empty((0,))  # the kernel reads no pointer of a missing draw
    launch_on_stream(lib.occ_sample, lib.occ_sample_error_string, "occ_sample",
                     (("rays_o", rays_o), ("rays_d", rays_d), ("near", near),
                      ("far", far), ("density", density),
                      ("t_rand", none if t_rand is None else t_rand),
                      ("u", none if u is None else u), ("z", z)),
                     n, config.n_candidates, n_samples, config.resolution,
                     int(config.weighting == "transmittance"), int(warmup),
                     int(t_rand is not None), int(u is not None),
                     scalars.ctypes.data, _kernel_orders(config, n))
    count("occ_sample.rays", n)
    return z


def _check_caps(lib) -> None:
    """Raise unless the built library's caps are ``MAX_CANDIDATES`` and
    ``MAX_SAMPLES``."""
    caps = (lib.occ_sample_max_candidates(), lib.occ_sample_max_samples())
    if caps != (MAX_CANDIDATES, MAX_SAMPLES):
        raise RuntimeError(f"csrc/occ_sample.cu's caps {caps} differ from "
                           f"ops/occupancy.py's "
                           f"{(MAX_CANDIDATES, MAX_SAMPLES)}")
