"""The flagship training step: render -> loss -> backward -> RAdam -> grid
refresh (train/step.py of the JAX package, its flagship subset).

    state, metrics = train_step(state, batch, config, generator)

The JAX step is one pure jitted function of a PRNG key; here the random
draws come from one ``torch.Generator`` on the device (``draw_step``), or
from an explicit ``draws`` dict, which the parity tests fill with the JAX
draws. The step updates ``state`` in place (parameters and moments) and
returns it. Scalars that the host needs only for printing (losses, PSNR)
stay on the device, so a step never waits for the card.

Off this path, with the ROADMAP.md Queue 1 item that brings each: the
hierarchical fine pass (item 4), structural priors, A-CAQ,
distortion, table decay, EMA, reg patches and appearance latents (item 5).
The CLI refuses their flags (``train/trainer.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from indoor_nerf_tpu_torch.models.field import init_field_params, sigma_query
from indoor_nerf_tpu_torch.ops.blockhash import block_tv_loss, draw_tv_rows
from indoor_nerf_tpu_torch.ops.occupancy import (
    OccState,
    draw_occupancy_update,
    init_occupancy,
    occupancy_update,
)
from indoor_nerf_tpu_torch.ops.rays import ndc_rays
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
    """Static training configuration: the JAX TrainConfig's flagship fields
    (reference flags: run_nerf.py:552-715), same defaults."""

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


def make_train_state(params: Dict[str, Any], occ: Optional[OccState]
                     ) -> TrainState:
    """A train state around ``params`` (every leaf made trainable), zero
    RAdam moments, the grid ``occ`` and fresh counters."""
    leaves = named_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    dev = leaves["table"].device
    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)
    return {
        "params": params,
        "opt": init_radam_state(leaves),
        "occ": occ,
        "step": 0,
        "best_loss": inf.clone(),
        "loss_ema": inf.clone(),
        "loss_ema_slow": inf.clone(),
    }


def init_train_state(generator: torch.Generator, config: TrainConfig,
                     device=None) -> TrainState:
    """Fresh train state: seeded params, zero moments, a fully occupied grid."""
    params = init_field_params(generator, config.render.field, device)
    occ = (init_occupancy(config.render.occupancy, device)
           if config.render.occupancy is not None else None)
    return make_train_state(params, occ)


def _tv_active(config: TrainConfig, step: int) -> bool:
    return config.tv_loss_weight > 0 and step <= config.tv_cutoff_iter


def _refresh_due(config: TrainConfig, step: int) -> bool:
    oc = config.render.occupancy
    return oc is not None and step % oc.update_interval == 0


def draw_step(generator: torch.Generator, config: TrainConfig, step: int,
              n_rays: int) -> Dict[str, torch.Tensor]:
    """Every draw step ``step`` takes: the render's (``draw_render``), the TV
    rows while TV is on, and the grid refresh's on refresh steps."""
    draws = draw_render(generator, n_rays, config.render)
    if _tv_active(config, step):
        draws["tv_rows"] = draw_tv_rows(generator, config.render.field.block_grid)
    if _refresh_due(config, step):
        cells, jitter = draw_occupancy_update(generator, config.render.occupancy)
        draws["occ_cells"], draws["occ_jitter"] = cells, jitter
    return draws


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               config: TrainConfig, generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step over the ``[N]`` rays of ``batch``
    (``rays_o``, ``rays_d``, ``target``, each ``[N, 3]``).

    The loss is MSE + ``sparse_loss_weight`` * the summed ray entropy +
    ``tv_loss_weight`` * ``block_tv_loss`` while ``step <= tv_cutoff_iter``
    (JAX :235-266). Then RAdam at the learning rate of the optimizer's step
    before its increment (:383), the loss EMAs (:392-411), and on every
    ``update_interval``-th step (step 0 included) the grid refresh, which
    reads the UPDATED params (:494-509). Returns (state, metrics{loss,
    img_loss, psnr, lr}); ``state`` is updated in place."""
    rc = config.render
    fc = rc.field
    step = state["step"]
    params = state["params"]
    rays_o, rays_d, target = batch["rays_o"], batch["rays_d"], batch["target"]
    if draws is None:
        draws = draw_step(generator, config, step, rays_o.shape[0])

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
    loss = img_loss + config.sparse_loss_weight * torch.sum(out["sparsity_loss"])
    if _tv_active(config, step):
        with record_function("tv"):
            tv = block_tv_loss(params["table"], fc.block_grid, draws["tv_rows"])
        loss = loss + config.tv_loss_weight * tv

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
    state["step"] = step + 1

    metrics = {
        "loss": loss.detach(),
        "img_loss": il,
        "psnr": -10.0 * torch.log(il) / math.log(10.0),
        "lr": lr,
    }
    return state, metrics
