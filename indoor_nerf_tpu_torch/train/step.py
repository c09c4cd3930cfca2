"""The training step: render -> loss -> backward -> RAdam -> grid refresh
(train/step.py of the JAX package, without A-CAQ, the reg patches and the
appearance latents).

    state, metrics = train_step(state, batch, config, generator)

The JAX step is one pure jitted function of a PRNG key; here the random
draws come from one ``torch.Generator`` on the device (``draw_step``), or
from an explicit ``draws`` dict, which the parity tests fill with the JAX
draws. The step updates ``state`` in place (parameters and moments) and
returns it. Scalars that the host needs only for printing (losses, PSNR)
stay on the device, the constants a step needs are copied to the device
once (``ops/constants.py``) and every count and fallback is a device
select, so a warm step never waits for the card
(``tests/test_torch_host_sync.py``).

The training extensions of the step: the structural priors
(``losses/priors.py``, from ``structural_loss_start_iter`` on, ramped over
``structural_loss_ramp_iters``, at the base weights the host passes in
``prior_weights``), the distortion loss (``losses/distortion.py``), the
fine-level table decay and the params EMA (``state["ema"]``). The field's
level and view anneals act inside the render (``models/field.py``).

Off this path, with the ROADMAP.md Queue 1 item that brings each: A-CAQ
(item 5b), the reg patches and appearance latents (item 5c). The CLI
refuses their flags (``train/trainer.py``).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from indoor_nerf_tpu_torch.losses.distortion import distortion_loss
from indoor_nerf_tpu_torch.losses.priors import (
    PriorConfig,
    combine_structural_losses,
    draw_priors,
)
from indoor_nerf_tpu_torch.models.field import init_field_params, sigma_query
from indoor_nerf_tpu_torch.ops.blockhash import block_tv_loss, draw_tv_rows
from indoor_nerf_tpu_torch.ops.occupancy import (
    OccState,
    draw_occupancy_update,
    init_occupancy,
    occupancy_update,
)
from indoor_nerf_tpu_torch.ops.rays import ndc_rays
from indoor_nerf_tpu_torch.ops.tv import draw_tv_origins, total_variation_loss
from indoor_nerf_tpu_torch.render.renderer import RenderConfig, draw_render, render_rays
from indoor_nerf_tpu_torch.train.optim import (
    exp_decay_lr,
    init_radam_state,
    named_leaves,
    pocketnerf_hyper_fn,
    radam_update,
)

TrainState = Dict[str, Any]

# Decay of the image-loss EMA: the default of the JAX QuantConfig's
# loss_ema_decay, which the JAX step reads from the field's quant config.
LOSS_EMA_DECAY = 0.99


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Static training configuration: the JAX TrainConfig's fields that the
    port runs (reference flags: run_nerf.py:552-715), same defaults."""

    render: RenderConfig
    near: float = 2.0
    far: float = 6.0
    # (H, W, focal) of the scene where ``render.ndc``: the batch's world
    # rays are projected into NDC with them (JAX train/step.py:197-212).
    ndc_hwf: Optional[Tuple[int, int, float]] = None
    n_rand: int = 1024
    lrate: float = 0.01
    lrate_decay: int = 250  # in thousands of steps
    sparse_loss_weight: float = 1e-10
    tv_loss_weight: float = 1e-6
    tv_cutoff_iter: int = 1000  # TV hard-disabled after this step
    # Mip-NeRF 360 distortion of the last pass's weights (0 = off).
    distortion_loss_weight: float = 0.0
    # weight * sum_l 2^(l - (L-1)) * mean(table_l^2): an L2 penalty that
    # bears hardest on the finest grid levels (0 = off; grids only).
    table_decay_weight: float = 0.0
    # Polyak EMA of the params (0 = off): state["ema"] <- ema * d +
    # params * (1 - d) after each update, from the initial params.
    ema_decay: float = 0.0
    use_structural_priors: bool = False
    structural_loss_start_iter: int = 2000
    structural_loss_ramp_iters: int = 1000
    priors: PriorConfig = PriorConfig()


def default_prior_weights() -> Dict[str, float]:
    """The reference CLI's prior weights (run_nerf.py:688-695); the step
    uses them where the caller passes none. ``depth_prior`` is carried as
    in the reference, where no loss reads it."""
    return {"depth_prior": 0.01, "planarity": 0.005, "manhattan": 0.002,
            "normal_consistency": 0.001}


def ema_copy(params: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of ``params`` that carries no gradient: the start of the
    params EMA."""
    ema = copy.deepcopy(params)
    for t in named_leaves(ema).values():
        t.requires_grad_(False)
    return ema


def make_train_state(params: Dict[str, Any], occ: Optional[OccState],
                     ema: bool = False) -> TrainState:
    """A train state around ``params`` (every leaf made trainable), zero
    RAdam moments, the grid ``occ``, fresh counters and, with ``ema``, the
    params EMA starting at ``params``."""
    leaves = named_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    dev = next(iter(leaves.values())).device
    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)
    return {
        "params": params,
        "opt": init_radam_state(leaves),
        "occ": occ,
        "ema": ema_copy(params) if ema else None,
        "step": 0,
        "best_loss": inf.clone(),
        "loss_ema": inf.clone(),
        "loss_ema_slow": inf.clone(),
    }


def init_train_state(generator: torch.Generator, config: TrainConfig,
                     device=None) -> TrainState:
    """Fresh train state: seeded params, zero moments, a fully occupied
    grid, and the params EMA where ``config.ema_decay > 0``."""
    params = init_field_params(generator, config.render.field, device)
    occ = (init_occupancy(config.render.occupancy, device)
           if config.render.occupancy is not None else None)
    return make_train_state(params, occ, ema=config.ema_decay > 0.0)


def eval_params(state: TrainState) -> Dict[str, Any]:
    """The params evaluation renders: the EMA where the state keeps one
    (JAX trainer.py:373-393, 740, 761), else the params."""
    return state["ema"] if state.get("ema") is not None else state["params"]


def _tv_active(config: TrainConfig, step: int) -> bool:
    """TV on the grid's table (either grid; none for PE) up to the cutoff."""
    return (config.render.field.uses_grid and config.tv_loss_weight > 0
            and step <= config.tv_cutoff_iter)


def priors_active(config: TrainConfig, step: int) -> bool:
    """The structural priors enter the loss from ``structural_loss_start_iter``
    on (the JAX ``lax.cond``, :364; the host knows the step)."""
    return (config.use_structural_priors and config.render.field.predict_normals
            and step >= config.structural_loss_start_iter)


def prior_ramp_weights(config: TrainConfig, step: int,
                       prior_weights: Optional[Dict[str, float]] = None
                       ) -> Dict[str, float]:
    """The weights of step ``step``: the base weights times ``0.1 + 0.9 *
    clip((step - start) / ramp, 0, 1)`` (JAX :331-344), in float32 as the
    JAX step computes them from its int32 step, returned as Python floats
    (no copy to the card)."""
    f32 = np.float32
    pw = prior_weights or default_prior_weights()
    ramp = np.clip(f32(step - config.structural_loss_start_iter)
                   / f32(config.structural_loss_ramp_iters), 0.0, 1.0)
    factor = f32(0.1) + f32(0.9) * f32(ramp)
    return {k: float(f32(pw[k]) * factor)
            for k in ("manhattan", "planarity", "normal_consistency")}


def _refresh_due(config: TrainConfig, step: int) -> bool:
    oc = config.render.occupancy
    return oc is not None and step % oc.update_interval == 0


def draw_step(generator: torch.Generator, config: TrainConfig, step: int,
              n_rays: int, with_coords: bool = False) -> Dict[str, Any]:
    """Every draw step ``step`` takes: the render's (``draw_render``), the TV
    rows (block grid) or cube origins (hash grid) while TV is on, the
    priors' (``draws["priors"]``, ``draw_priors``; ``with_coords`` where the
    batch carries ``spatial_coords``) once they are active, and the grid
    refresh's on refresh steps."""
    draws = draw_render(generator, n_rays, config.render)
    fc = config.render.field
    if _tv_active(config, step):
        if fc.i_embed == 1:
            draws["tv_origins"] = draw_tv_origins(generator, fc.grid)
        else:
            draws["tv_rows"] = draw_tv_rows(generator, fc.block_grid)
    if priors_active(config, step):
        draws["priors"] = draw_priors(generator, n_rays, with_coords,
                                      config.priors)
    if _refresh_due(config, step):
        cells, jitter = draw_occupancy_update(generator, config.render.occupancy)
        draws["occ_cells"], draws["occ_jitter"] = cells, jitter
    return draws


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               config: TrainConfig, generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, Any]] = None,
               prior_weights: Optional[Dict[str, float]] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step over the ``[N]`` rays of ``batch``
    (``rays_o``, ``rays_d``, ``target``, each ``[N, 3]``, and optionally
    ``spatial_coords`` ``[N, 2]``, the pixels' (row, col), which the
    priors' consistency term pairs by).

    The loss is MSE + ``sparse_loss_weight`` * the summed ray entropy (with
    a fine pass, of both passes: the coarse pass's MSE and entropy are
    added) + ``tv_loss_weight`` * the grid's TV (``block_tv_loss`` or the
    hash grid's ``total_variation_loss``) while ``step <= tv_cutoff_iter``
    (JAX :235-266), + the distortion (:270-274), + the table decay
    (:281-292), + the structural priors once active, at
    ``prior_ramp_weights`` of the host's base ``prior_weights``
    (``default_prior_weights`` where None; :331-368). Then RAdam at the
    learning rate of the optimizer's step before its increment (:383), the
    loss EMAs (:392-411), on every ``update_interval``-th step (step 0
    included) the grid refresh, which reads the UPDATED params (:494-509),
    and the params EMA (:511-517). Returns (state, metrics{loss, img_loss,
    psnr, lr} and, on steps with the priors, the ``structural_*``
    diagnostics of ``combine_structural_losses``); ``state`` is updated in
    place."""
    rc = config.render
    fc = rc.field
    step = state["step"]
    params = state["params"]
    rays_o, rays_d, target = batch["rays_o"], batch["rays_d"], batch["target"]
    spatial_coords = batch.get("spatial_coords")
    if draws is None:
        draws = draw_step(generator, config, step, rays_o.shape[0],
                          spatial_coords is not None)

    viewdirs = None
    if fc.use_viewdirs:
        # From the world rays, before the NDC projection (reference order:
        # run_nerf.py:119-131).
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if rc.ndc:
        if config.ndc_hwf is None:
            raise ValueError(
                "render.ndc=True needs TrainConfig.ndc_hwf=(H, W, focal) "
                "to project training ray batches into NDC")
        Hn, Wn, focal_n = config.ndc_hwf
        rays_o, rays_d = ndc_rays(Hn, Wn, focal_n, 1.0, rays_o, rays_d)
    near = config.near * torch.ones_like(rays_d[..., :1])
    far = config.far * torch.ones_like(rays_d[..., :1])

    out = render_rays(params, rays_o, rays_d, viewdirs, near, far, rc,
                      occ_state=state["occ"], step=step, draws=draws)
    img_loss = torch.mean((out["rgb_map"] - target) ** 2)
    loss = img_loss
    sparsity = torch.sum(out["sparsity_loss"])
    if "rgb0" in out:
        loss = loss + torch.mean((out["rgb0"] - target) ** 2)
        sparsity = sparsity + torch.sum(out["sparsity_loss0"])
    loss = loss + config.sparse_loss_weight * sparsity
    if _tv_active(config, step):
        with record_function("tv"):
            if fc.i_embed == 1:
                tv = total_variation_loss(params["table"], fc.grid,
                                          draws["tv_origins"])
            else:
                tv = block_tv_loss(params["table"], fc.block_grid,
                                   draws["tv_rows"])
        loss = loss + config.tv_loss_weight * tv
    if config.distortion_loss_weight > 0:
        loss = loss + config.distortion_loss_weight * distortion_loss(
            out["weights"], out["z_vals"], near, far)
    if config.table_decay_weight > 0 and fc.uses_grid:
        g = fc.block_grid if fc.i_embed == 3 else fc.grid
        L = g.n_levels
        per_level = torch.mean(params["table"].reshape(L, -1) ** 2, dim=1)
        # Level l weighs 2^(l - (L-1)): the finest 1, each coarser half.
        decay = sum(per_level[l] * 2.0 ** (l - (L - 1)) for l in range(L))
        loss = loss + config.table_decay_weight * decay
    diag = {}
    if priors_active(config, step):
        with record_function("priors"):
            structural, diag = combine_structural_losses(
                out["depth_map"], out["normal_map"], spatial_coords,
                prior_ramp_weights(config, step, prior_weights),
                draws["priors"], config.priors)
        loss = loss + structural

    leaves = named_leaves(params)
    with record_function("backward"):
        grads = torch.autograd.grad(loss, list(leaves.values()))
    lr = exp_decay_lr(config.lrate, config.lrate_decay, state["opt"]["step"])
    with record_function("optimizer"):
        radam_update(leaves, dict(zip(leaves, grads)), state["opt"], lr,
                     pocketnerf_hyper_fn)

    il = img_loss.detach()
    d = LOSS_EMA_DECAY
    d_slow = 1.0 - (1.0 - d) / 10.0
    ema = state["loss_ema"]
    state["loss_ema"] = torch.where(torch.isinf(ema), il, d * ema + (1.0 - d) * il)
    slow = state["loss_ema_slow"]
    state["loss_ema_slow"] = torch.where(torch.isinf(slow), il,
                                         d_slow * slow + (1.0 - d_slow) * il)
    state["best_loss"] = torch.minimum(state["best_loss"], state["loss_ema"])

    if _refresh_due(config, step):
        mlp_name = "fine" if "fine" in params else "coarse"
        with torch.no_grad(), record_function("occ_update"):
            state["occ"] = occupancy_update(
                state["occ"], lambda pts: sigma_query(params, mlp_name, pts, fc),
                rc.occupancy, draws["occ_cells"], draws["occ_jitter"])
    if config.ema_decay > 0.0 and state.get("ema") is not None:
        d = config.ema_decay
        with torch.no_grad():
            ema_leaves = named_leaves(state["ema"])
            for name, p in leaves.items():
                e = ema_leaves[name]
                e.copy_(e * d + p * (1.0 - d))
    state["step"] = step + 1

    metrics = {
        "loss": loss.detach(),
        "img_loss": il,
        "psnr": -10.0 * torch.log(il) / math.log(10.0),
        "lr": lr,
    }
    metrics.update({f"structural_{k}": v.detach() for k, v in diag.items()})
    return state, metrics
