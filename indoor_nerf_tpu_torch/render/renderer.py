"""Volumetric rendering (render/renderer.py of the JAX package).

``render_rays`` runs the occupancy-guided single pass (the flagship), the
stratified single pass (``n_importance == 0``) or the hierarchical one
(stratified coarse samples, then ``n_importance`` more drawn from the
coarse weights, and the fine net on all of them). Full images are rendered
as a Python loop over ray tiles in place of the JAX ``lax.map``, tiles
sized from the card's free memory and the config (``bytes_per_ray``).
Serving draws no random numbers: ``test_mode`` sets ``perturb = 0`` and no
sigma noise. Training passes the jitter and sigma-noise draws
(``draw_render``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from indoor_nerf_tpu_torch.models.field import (
    FieldConfig,
    params_device,
    query_field,
    serving_params,
)
from indoor_nerf_tpu_torch.ops.occupancy import OccState, OccupancyConfig, occupancy_z_vals
from indoor_nerf_tpu_torch.ops.rays import get_rays, ndc_rays
from indoor_nerf_tpu_torch.ops.sampling import (
    draw_pdf_u,
    draw_stratified,
    sample_pdf,
    stratified_z_vals,
)
from indoor_nerf_tpu_torch.ops.volume import draw_sigma_noise, raw2outputs
from indoor_nerf_tpu_torch.utils.spans import span

MAP_KEYS = ("rgb_map", "depth_map", "acc_map", "disp_map")

# Device bytes one ray of the flagship render holds at its peak (occupancy
# ladder of 128 candidates, 32 samples x 8 levels of encode intermediates,
# the MLP activations): 31.7-32.6 KB measured with max_memory_allocated at
# tiles of 16k-640k rays on an H100 (PERF.md). Sizes tiles from free memory.
BYTES_PER_RAY = 32 * 1024
# The JAX server's tile for i_embed 3 (scripts/serve.py:122): the CPU tile.
CPU_TILE_RAYS = 2048


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering configuration (the JAX RenderConfig)."""

    field: FieldConfig
    n_samples: int = 64
    n_importance: int = 0
    perturb: float = 1.0
    lindisp: bool = False
    white_bkgd: bool = False
    raw_noise_std: float = 0.0
    ndc: bool = False
    occupancy: Optional[OccupancyConfig] = None
    n_occ_samples: int = 64

    def test_mode(self) -> "RenderConfig":
        """Test-time variant: no jitter, no sigma noise."""
        return dataclasses.replace(self, perturb=0.0, raw_noise_std=0.0)


def _draw_shapes(config: RenderConfig, n_rays: int) -> Dict[str, Tuple[int, int]]:
    """The draws a render of ``n_rays`` rays takes under ``config``."""
    occ = config.occupancy
    n_samples = config.n_samples if occ is None else config.n_occ_samples
    fine = occ is None and config.n_importance > 0
    shapes = {}
    if config.perturb != 0.0:
        if occ is None:
            shapes["t_rand"] = (n_rays, config.n_samples)
            if fine:
                shapes["u"] = (n_rays, config.n_importance)
        else:
            shapes["t_rand"] = (n_rays, occ.n_candidates)
            shapes["u"] = (n_rays, config.n_occ_samples)
    if config.raw_noise_std > 0.0:
        shapes["sigma_noise"] = (n_rays, n_samples)
        if fine:
            shapes["sigma_noise1"] = (n_rays, n_samples + config.n_importance)
    return shapes


def draw_render(generator: torch.Generator, n_rays: int,
                config: RenderConfig) -> Dict[str, torch.Tensor]:
    """A training render's draws from ``generator`` (on its device):
    ``t_rand`` (stratum jitter), ``u`` (inverse-CDF draws of the occupancy
    path or of the fine pass), ``sigma_noise`` and, on the hierarchical
    path, ``sigma_noise1`` of the fine pass (already scaled by
    ``raw_noise_std``), each only where ``config`` uses it. Empty for
    ``test_mode()`` configs."""
    out = {}
    for k, shape in _draw_shapes(config, n_rays).items():
        if k == "t_rand":
            out[k] = draw_stratified(generator, *shape)
        elif k == "u":
            out[k] = draw_pdf_u(generator, *shape)
        else:  # sigma_noise, sigma_noise1
            out[k] = draw_sigma_noise(generator, shape, config.raw_noise_std)
    return out


def render_rays(params: Dict[str, Any], rays_o: torch.Tensor,
                rays_d: torch.Tensor, viewdirs: Optional[torch.Tensor],
                near: torch.Tensor, far: torch.Tensor, config: RenderConfig,
                occ_state: Optional[OccState] = None,
                step: Optional[int] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None,
                quant_state: Optional[Dict[str, Any]] = None,
                train: bool = True,
                view_bias: Optional[torch.Tensor] = None
                ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, Any]]]:
    """Render ``[N]`` rays (``rays_o``/``rays_d`` ``[N, 3]``, ``near``/``far``
    ``[N, 1]``). Returns (outputs, quant_state); the outputs are
    rgb/depth/acc/disp maps, the entropy ``sparsity_loss``, ``weights``,
    ``z_vals`` (of the last pass: the distortion loss reads both) and
    ``pts``, and with ``predict_normals``
    ``normal_map``; the hierarchical path also the coarse pass's ``rgb0``,
    ``depth0``, ``acc0``, ``sparsity_loss0`` (and ``normal0``), and
    ``z_std``, the population std of the fine samples' depths. A training
    render passes its ``step``, which also drives the field's anneals.

    A ``test_mode()`` config renders deterministically (the fine samples at
    the inverse CDF of a linspace). Otherwise ``draws`` (``draw_render``)
    carries the jitter and sigma noise, as the JAX ``render_rays`` key does
    with ``train=True``.

    ``quant_state``, ``train`` and ``step`` go to every field query (A-CAQ,
    JAX renderer.py:66-133): a training render returns the state its
    queries calibrated, coarse pass first; with ``quant_state`` None every
    fake quantizer is bypassed. ``view_bias`` ``[N, D]`` (appearance
    latents) goes to the queries of both passes."""
    draws = draws or {}
    missing = sorted(set(_draw_shapes(config, rays_o.shape[0])) - set(draws))
    if missing:
        raise ValueError(f"render with perturb={config.perturb}, raw_noise_std="
                         f"{config.raw_noise_std} needs the draws {missing} "
                         "(draw_render), or a test_mode() config")
    fc = config.field
    if config.occupancy is not None and occ_state is not None:
        with span("sample"):
            z_vals = occupancy_z_vals(rays_o, rays_d, near, far, occ_state,
                                      config.occupancy, config.n_occ_samples,
                                      step, t_rand=draws.get("t_rand"),
                                      u=draws.get("u"))
        mlp_name = "fine" if "fine" in params else "coarse"
    else:
        with span("sample"):
            z_vals = stratified_z_vals(near, far, config.n_samples,
                                       lindisp=config.lindisp,
                                       t_rand=draws.get("t_rand"))
        mlp_name = "coarse"
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    raw, quant_state = query_field(params, mlp_name, pts, viewdirs, fc, step,
                                   quant_state, train, view_bias)
    with span("composite"):
        out = raw2outputs(raw, z_vals, rays_d, white_bkgd=config.white_bkgd,
                          sigma_noise=draws.get("sigma_noise"))

    if config.occupancy is None and config.n_importance > 0:
        coarse = out
        with span("sample"):
            z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            z_samples = sample_pdf(z_mid, coarse["weights"][..., 1:-1],
                                   config.n_importance,
                                   u=draws.get("u")).detach()
            z_vals = torch.sort(torch.cat([z_vals, z_samples], -1), -1).values
        pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
        raw, quant_state = query_field(
            params, "fine" if "fine" in params else "coarse", pts, viewdirs,
            fc, step, quant_state, train, view_bias)
        with span("composite"):
            out = raw2outputs(raw, z_vals, rays_d,
                              white_bkgd=config.white_bkgd,
                              sigma_noise=draws.get("sigma_noise1"))
        out["rgb0"] = coarse["rgb_map"]
        out["depth0"] = coarse["depth_map"]
        out["acc0"] = coarse["acc_map"]
        out["sparsity_loss0"] = coarse["sparsity_loss"]
        if "normal_map" in coarse:
            out["normal0"] = coarse["normal_map"]
        out["z_std"] = torch.std(z_samples, dim=-1, correction=0)
    out["z_vals"] = z_vals
    out["pts"] = pts
    return out, quant_state


def _prepare_rays(rays_o: torch.Tensor, rays_d: torch.Tensor, H: int,
                  W: int, focal: float, near: float, far: float,
                  config: RenderConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                             torch.Tensor, torch.Tensor]:
    """Unit viewdirs (of the world rays) + the NDC projection where
    ``config.ndc`` + flat rays + per-ray bounds (JAX renderer.py:205-227)."""
    viewdirs = None
    if config.field.use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        viewdirs = viewdirs.reshape(-1, 3)
    if config.ndc:
        rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    near_a = near * torch.ones_like(rays_d[..., :1])
    far_a = far * torch.ones_like(rays_d[..., :1])
    return rays_o, rays_d, viewdirs, near_a, far_a


# Device bytes per sample of the compositing and sampling tensors of a
# pass beside the encode and the MLP (raw, rgb, alpha, weights, depths,
# points, their temporaries). With it the reckoning of ``_sample_bytes``
# lies above the peak per ray of a tile measured with max_memory_allocated
# on an H100 at configs/lego.txt's width, hash grid and PE (chip_smoke.py
# phases y4, y5; PERF.md §6).
SAMPLE_BYTES = 160


def _sample_bytes(fc: FieldConfig) -> int:
    """Device bytes one sample holds at the peak of a test-mode pass with
    the hash grid or PE: the encode's live tensors (hash grid: the int32
    corner rows, the f32 corner weights, the gathered corner features and
    their weighted copy, ``L * (32 + 32 + 64 F)``; PE: the features and a
    band's sin and cos) and the widest MLP layer's input and output."""
    if fc.i_embed == 1:
        g = fc.grid
        enc = g.n_levels * (32 + 32 + 64 * g.n_features_per_level)
        mlp = 4 * (fc.input_ch + fc.input_ch_views
                   + 2 * max(fc.hidden_dim, fc.hidden_dim_color))
    else:
        enc = 4 * 3 * fc.input_ch
        width = max(fc.netwidth, fc.netwidth_fine)
        mlp = 4 * (3 * width + fc.input_ch + fc.input_ch_views)
    return enc + mlp + SAMPLE_BYTES


# The activation quantizer of a quantized field (A-CAQ, evaluation mode)
# holds f32 copies of a hidden layer's [samples, hidden_dim] activations
# beside them (h / scale + zero point, its rounding and clamp, the
# dequantized result: losses/quantization.py::learned_fake_quant) and the
# MLP's own: chip_smoke.py's (aq1) measured a quantized flagship test set at
# 77.6 KB a ray on an H100 (9.89 GiB above the memory held before it, in
# tiles of 131,072 rays), 45.6 KB over the unquantized render's 32 KB, or
# 5.6 copies of 32 samples x 64 f32 (PERF.md §6). Six copies bound it.
ACT_QUANT_COPIES = 6


def _act_quant_bytes(fc: FieldConfig) -> int:
    """Device bytes per sample of the activation quantizer's copies
    (``ACT_QUANT_COPIES``) in a quantized grid field; 0 otherwise."""
    if not (fc.use_quantization and fc.uses_grid):
        return 0
    return ACT_QUANT_COPIES * 4 * fc.hidden_dim


def bytes_per_ray(config: Optional[RenderConfig] = None) -> int:
    """Device bytes one ray of a test-mode render holds at its peak.

    The block-hash grid (``i_embed 3``): ``BYTES_PER_RAY``, plus, on the
    tile-interp route of the encode, the gathered rows, which that route
    alone keeps in device memory: samples x levels rows of ``F * lpf`` f32
    (32 x 16 x 1 KiB = 512 KiB at the block-hash defaults), and their bf16
    form before the cast where the gather reads bf16.

    The hash grid and PE: the samples of the largest pass (the fine pass's
    ``n_samples + n_importance``) at ``_sample_bytes`` (0.76 MB at
    configs/lego.txt's 192 samples x 16 levels).

    A quantized grid field adds its activation quantizer's copies,
    ``_act_quant_bytes`` a sample (48 KiB a ray at the flagship's 32
    samples x 64)."""
    if config is None:
        return BYTES_PER_RAY
    fc = config.field
    if fc.i_embed != 3:
        n = (config.n_occ_samples if config.occupancy is not None
             else config.n_samples + config.n_importance)
        return n * (_sample_bytes(fc) + _act_quant_bytes(fc))
    bg = fc.block_grid
    n_samples = (config.n_samples if config.occupancy is None
                 else config.n_occ_samples)
    quant = n_samples * _act_quant_bytes(fc)
    if not bg.uses_tile_interp:
        return BYTES_PER_RAY + quant
    row_bytes = bg.n_features_per_level * bg.lanes_per_feature * (
        4 + (2 if bg.gather_dtype == "bfloat16" else 0))
    return BYTES_PER_RAY + quant + n_samples * bg.n_levels * row_bytes


def default_tile_rays(device: torch.device,
                      config: Optional[RenderConfig] = None) -> int:
    """Rays per tile: a quarter of the card's free memory at
    ``bytes_per_ray(config)``, as a power of two in [2^12, 2^20]; 2048 on
    the CPU."""
    if device.type != "cuda":
        return CPU_TILE_RAYS
    free, _ = torch.cuda.mem_get_info(device)
    n = max(1, free // 4 // bytes_per_ray(config))
    return int(min(1 << 20, max(1 << 12, 1 << (n.bit_length() - 1))))


def pose_rays(c2ws: torch.Tensor, K: torch.Tensor, H: int, W: int,
              near: float, far: float, config: RenderConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                         torch.Tensor, torch.Tensor]:
    """The flat rays of ``c2ws`` ``[B, 3, 4]``, pose by pose in row-major
    pixel order: (rays_o, rays_d, viewdirs, near, far) of
    ``_prepare_rays``."""
    rays = [get_rays(H, W, K, c2w) for c2w in c2ws]
    rays_o = torch.stack([r[0] for r in rays])
    rays_d = torch.stack([r[1] for r in rays])
    return _prepare_rays(rays_o, rays_d, H, W, float(K[0][0]), near, far,
                         config)


@torch.inference_mode()
def render_ray_tiles(params: Dict[str, Any], rays_o: torch.Tensor,
                     rays_d: torch.Tensor, viewdirs: Optional[torch.Tensor],
                     near_a: torch.Tensor, far_a: torch.Tensor,
                     config: RenderConfig, tile_rays: int,
                     occ_state: Optional[OccState] = None,
                     quant_state: Optional[Dict[str, Any]] = None,
                     view_bias: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
    """The flat maps ``MAP_KEYS`` of ``[n]`` rays rendered in test mode, in
    tiles of ``tile_rays`` (the last one short)."""
    test_cfg = config.test_mode()
    outs = {k: [] for k in MAP_KEYS}
    for s in range(0, rays_o.shape[0], tile_rays):
        sl = slice(s, s + tile_rays)
        n = rays_o[sl].shape[0]
        out, _ = render_rays(
            params, rays_o[sl], rays_d[sl],
            None if viewdirs is None else viewdirs[sl],
            near_a[sl], far_a[sl], test_cfg, occ_state=occ_state, step=None,
            quant_state=quant_state, train=False,
            view_bias=(None if view_bias is None
                       else view_bias[None].expand(n, -1)))
        for k in MAP_KEYS:
            outs[k].append(out[k])
    return {k: torch.cat(v) for k, v in outs.items()}


@torch.inference_mode()
def _render_pose_block(params: Dict[str, Any], c2ws: torch.Tensor,
                       K: torch.Tensor, near: float, far: float,
                       config: RenderConfig, H: int, W: int, tile_rays: int,
                       occ_state: Optional[OccState] = None,
                       quant_state: Optional[Dict[str, Any]] = None,
                       view_bias: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    """Render ``c2ws`` ``[B, 3, 4]`` poses; maps carry a leading B axis.
    A quantized field renders with ``quant_state`` in evaluation mode
    (rounded bits, the calibrated levels). ``view_bias`` ``[D]`` is one
    appearance latent for every ray (JAX renderer.py:316-319); without it
    the field renders with the zero latent."""
    B = c2ws.shape[0]
    rays = pose_rays(c2ws, K, H, W, near, far, config)
    flat = render_ray_tiles(params, *rays, config, tile_rays, occ_state,
                            quant_state, view_bias)
    return {
        "rgb_map": flat["rgb_map"].reshape(B, H, W, 3),
        "depth_map": flat["depth_map"].reshape(B, H, W),
        "acc_map": flat["acc_map"].reshape(B, H, W),
        "disp_map": flat["disp_map"].reshape(B, H, W),
    }


def make_image_renderer(config: RenderConfig, H: int, W: int,
                        tile_rays: Optional[int] = None):
    """A full-image renderer ``(params, c2w, K, near, far[, occ_state,
    quant_state, view_bias]) -> maps`` on the device of the params.
    ``tile_rays=None`` sizes tiles from the card's memory and ``config``
    (``default_tile_rays``). ``params`` are ``serving_params`` (of the
    same ``quant_state`` for a quantized field); ``view_bias`` is an
    appearance latent ``[D]`` shared by every ray (a fitted one,
    ``render/appearance.py``)."""

    def render_fn(params, c2w, K, near, far, occ_state=None, quant_state=None,
                  view_bias=None):
        dev = params_device(params)
        tile = tile_rays or default_tile_rays(dev, config)
        c2w = torch.as_tensor(np.asarray(c2w, np.float32)[:3, :4], device=dev)
        K = torch.as_tensor(np.asarray(K, np.float32), device=dev)
        if view_bias is not None:
            view_bias = torch.as_tensor(view_bias, dtype=torch.float32,
                                        device=dev)
        out = _render_pose_block(params, c2w[None], K, float(near),
                                 float(far), config, H, W, tile, occ_state,
                                 quant_state, view_bias)
        return {k: v[0] for k, v in out.items()}

    return render_fn


def render_image(params: Dict[str, Any], H: int, W: int, K: np.ndarray,
                 c2w: np.ndarray, near: float, far: float,
                 config: RenderConfig, tile_rays: Optional[int] = None,
                 occ_state: Optional[OccState] = None,
                 quant_state: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, np.ndarray]:
    """Convenience single-image render to numpy; see make_image_renderer."""
    params = serving_params(params, config.field, quant_state)
    out = make_image_renderer(config, H, W, tile_rays)(
        params, c2w, K, near, far, occ_state, quant_state)
    return {k: v.cpu().numpy() for k, v in out.items()}
