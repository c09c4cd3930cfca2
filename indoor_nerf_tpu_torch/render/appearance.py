"""Test-time appearance latents: the NeRF-W half-image protocol
(render/appearance.py of the JAX package).

A field trained with per-image appearance latents (``--use_appearance``,
``FieldConfig.n_appearance``) has no latent for a held-out view, whose
exposure is unknown too on a real capture. NeRF-W's evaluation
(Martin-Brualla et al., CVPR 2021, sec. 5) fits a fresh latent on the LEFT
half of the held-out image and scores PSNR on the RIGHT half, so the fit
never sees the scored pixels.

``fit_view_latent`` runs ``n_steps`` Adam steps on the ``[D]`` latent alone
(JAX's constants and bias correction, ``_fit_latent`` :66), each a
test-mode render of a fixed left-half ray subset. The field's tensors
carry no gradient there: the params are packed once per fit
(``serving_params``) and the nets copied without ``requires_grad``, so no
gradient reaches the field and the encode's backward kernel never runs.
The loop reads no value on the host; the final MSE is read once.

``_left_half_rays``, ``right_half_psnr``, ``fit_affine_color`` and
``eval_view_with_fitted_affine`` are numpy COPIES of the JAX functions
(``tests/test_torch_appearance.py`` holds each equal on the same seeds).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from indoor_nerf_tpu_torch.models.field import params_device, serving_params
from indoor_nerf_tpu_torch.ops.occupancy import OccState
from indoor_nerf_tpu_torch.ops.rays import get_rays_np
from indoor_nerf_tpu_torch.render.renderer import RenderConfig, render_rays

_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def _left_half_rays(
    gt: np.ndarray,
    c2w: np.ndarray,
    K: np.ndarray,
    n_rays: int,
    seed: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A fixed random subset of rays from the left half of the image.

    Host-side numpy (the subset is part of the eval protocol). Returns
    (rays_o [N,3], rays_d [N,3], target [N,3]).
    """
    H, W = gt.shape[:2]
    rays_o, rays_d = get_rays_np(H, W, K, c2w)
    rng = np.random.default_rng(seed)
    n_rays = min(n_rays, H * (W // 2))
    ys = rng.integers(0, H, size=n_rays)
    xs = rng.integers(0, W // 2, size=n_rays)
    return (
        rays_o[ys, xs].astype(np.float32),
        rays_d[ys, xs].astype(np.float32),
        np.asarray(gt, np.float32)[ys, xs],
    )


def _frozen_field(params: Dict[str, Any], config: RenderConfig
                  ) -> Dict[str, Any]:
    """``serving_params`` of ``params`` (the table packed once, detached)
    with each net copied without ``requires_grad`` and no appearance
    table: a field no gradient can reach."""
    field = serving_params(params, config.field)
    field.pop("appearance", None)
    for name in ("coarse", "fine"):
        if name in field:
            field[name] = copy.deepcopy(field[name]).requires_grad_(False)
    return field


def left_half_loss(
    params: Dict[str, Any],
    c2w: np.ndarray,
    K: np.ndarray,
    near: float,
    far: float,
    gt: np.ndarray,
    config: RenderConfig,
    occ_state: Optional[OccState] = None,
    n_rays: int = 2048,
    seed: int = 0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``loss(z)``: the MSE over a fixed ``n_rays`` subset of a view's LEFT
    half (``_left_half_rays``) of a test-mode render with the occupancy
    grid ``occ_state`` and the ``[D]`` latent ``z`` added to every ray's
    view features, on the frozen field (``_frozen_field``); no quantizer
    (the JAX fit passes none)."""
    fc = config.field
    if not fc.use_viewdirs:
        raise ValueError("appearance latents ride the view encoding: the "
                         "fit needs a field with --use_viewdirs")
    field = _frozen_field(params, config)
    dev = params_device(field)
    ro, rd, tgt = (torch.from_numpy(a).to(dev) for a in _left_half_rays(
        gt, np.asarray(c2w), np.asarray(K), n_rays, seed))
    n = ro.shape[0]
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    near_a = torch.full((n, 1), float(near), device=dev)
    far_a = torch.full((n, 1), float(far), device=dev)
    tcfg = config.test_mode()

    def loss_fn(z):
        out, _ = render_rays(field, ro, rd, vd, near_a, far_a, tcfg,
                             occ_state=occ_state, train=False,
                             view_bias=z[None].expand(n, fc.input_ch_views))
        return torch.mean((out["rgb_map"] - tgt) ** 2)

    return loss_fn


def fit_view_latent(
    params: Dict[str, Any],
    c2w: np.ndarray,
    K: np.ndarray,
    near: float,
    far: float,
    gt: np.ndarray,
    config: RenderConfig,
    occ_state: Optional[OccState] = None,
    n_steps: int = 100,
    n_rays: int = 2048,
    lrate: float = 0.05,
    seed: int = 0,
) -> Tuple[torch.Tensor, float]:
    """Fit a single ``[D]`` appearance latent to a view's LEFT half:
    full-batch Adam from zero on ``left_half_loss``. Returns (latent
    ``[D]`` float32 on the params' device, the final left-half MSE)."""
    loss_fn = left_half_loss(params, c2w, K, near, far, gt, config,
                             occ_state, n_rays, seed)
    dev = params_device(params)
    f32 = np.float32
    lr = float(f32(lrate))
    # The bias corrections in float32, as the JAX scan computes them from
    # its float32 step, on the device once: on the card a division by a
    # Python number is a multiply by its rounded reciprocal.
    t1 = np.arange(1, n_steps + 1, dtype=f32)
    c1, c2 = (torch.from_numpy(f32(1.0) - np.power(f32(b), t1)).to(dev)
              for b in (_ADAM_B1, _ADAM_B2))
    z = torch.zeros(config.field.input_ch_views, device=dev)
    m, v = torch.zeros_like(z), torch.zeros_like(z)
    for t in range(n_steps):
        z.requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(z), [z])
        with torch.no_grad():
            m = _ADAM_B1 * m + (1.0 - _ADAM_B1) * g
            v = _ADAM_B2 * v + (1.0 - _ADAM_B2) * g * g
            z = z - lr * (m / c1[t]) / (torch.sqrt(v / c2[t]) + _ADAM_EPS)
    with torch.no_grad():
        final = loss_fn(z)
    return z.detach(), float(final)


def right_half_psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    """PSNR restricted to the right half of the image (the scored half)."""
    W = gt.shape[1]
    mse = float(np.mean(
        (np.asarray(pred, np.float32)[:, W // 2:]
         - np.asarray(gt, np.float32)[:, W // 2:]) ** 2))
    return float(-10.0 * np.log10(max(mse, 1e-12)))


def eval_view_with_fitted_latent(
    render_fn,
    params: Dict[str, Any],
    c2w: np.ndarray,
    K: np.ndarray,
    near: float,
    far: float,
    gt: np.ndarray,
    config: RenderConfig,
    occ_state: Optional[OccState] = None,
    **fit_kwargs,
) -> Dict[str, float]:
    """Half-image evaluation of one held-out view.

    ``render_fn`` is a ``make_image_renderer`` product (it takes
    ``view_bias=``); ``params`` the train state's. Returns right-half PSNR
    with the zero latent and with the fitted latent, plus the fit's final
    left-half MSE."""
    field = serving_params(params, config.field)
    z, fit_mse = fit_view_latent(field, c2w, K, near, far, gt, config,
                                 occ_state=occ_state, **fit_kwargs)
    c2w = np.asarray(c2w)[:3, :4]
    out0 = render_fn(field, c2w, K, near, far, occ_state)
    outz = render_fn(field, c2w, K, near, far, occ_state, view_bias=z)
    return {
        "psnr_right_zero": right_half_psnr(out0["rgb_map"].cpu().numpy(), gt),
        "psnr_right_fitted": right_half_psnr(outz["rgb_map"].cpu().numpy(),
                                             gt),
        "fit_mse_left": fit_mse,
    }


def fit_affine_color(pred: np.ndarray, gt: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form per-channel affine color fit ``gt ~ a * pred + b``.

    Exposure / white-balance is an AFFINE property of the capture (gain x
    linear radiance + black-level offset), so the per-view unknown is 6
    numbers, not a field latent. Ordinary least squares per channel over
    the given pixels: ``a = cov(pred, gt) / var(pred)``,
    ``b = mean(gt) - a * mean(pred)``. Near-constant predictions
    (var ~ 0) degrade to identity gain. Returns (a ``[3]``, b ``[3]``)
    float32.
    """
    p = np.asarray(pred, np.float32).reshape(-1, 3)
    g = np.asarray(gt, np.float32).reshape(-1, 3)
    pm, gm = p.mean(axis=0), g.mean(axis=0)
    var = ((p - pm) ** 2).mean(axis=0)
    cov = ((p - pm) * (g - gm)).mean(axis=0)
    a = np.where(var > 1e-8, cov / np.maximum(var, 1e-8), 1.0)
    b = gm - a * pm
    return a.astype(np.float32), b.astype(np.float32)


def eval_view_with_fitted_affine(pred: np.ndarray, gt: np.ndarray
                                 ) -> Dict[str, float]:
    """Half-image affine protocol on an ALREADY-RENDERED view: the
    6-parameter affine colour transform fitted on the LEFT half of the view
    (closed form, no model requirements) and scored on the RIGHT half,
    the same no-leak split as the latent protocol above."""
    pred = np.asarray(pred, np.float32)
    W = gt.shape[1]
    a, b = fit_affine_color(pred[:, : W // 2], np.asarray(gt)[:, : W // 2])
    adj = np.clip(pred * a[None, None] + b[None, None], 0.0, 1.0)
    return {
        "psnr_right_zero": right_half_psnr(pred, gt),
        "psnr_right_affine": right_half_psnr(adj, gt),
        "gain": [float(v) for v in a],
        "bias": [float(v) for v in b],
    }
