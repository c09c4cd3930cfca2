"""The training step: render -> loss -> backward -> RAdam -> grid refresh
(train/step.py of the JAX package).

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

A quantized field (``--use_quantization``) keeps its quantizer state in
``state["quant"]``: the render's queries calibrate it, and with
``use_acaq`` the bitwidth controller moves its bits every
``acaq_interval`` steps from ``acaq_start_iter`` on (the host knows the
step, so the JAX ``lax.cond`` is a branch here), in MDL mode from a second,
quantizer-free forward on the same rays and draws and ``state["infl_ema"]``.

``--reg_views`` adds the batch's patch rays (``reg_rays_o``, ``reg_rays_d``
of ``data/pipeline.py::UnobservedPatchSampler``): a second training render
through the same field, occupancy grid and quantizer state, with draws of
its own (``draws["reg"]``, made after every other draw of the step), whose
depth smoothness (``ops/tv.py::patch_depth_regularizer``) enters the loss
at ``reg_depth_tv_weight`` from ``reg_start_iter`` on; its quantizer
calibration is dropped. The render runs on every step, as JAX's does: the
gate only multiplies its term. ``--use_appearance`` adds the rows of
``params["appearance"]`` of the batch's ``img_idx`` to its rays' view
features (``_view_bias``).

With ``render.chain`` the step is a proposal-chain model's
(``_train_step_proposal``; nerfacto, Mip-NeRF 360): the chain's render
(``render/proposal.py``), and the model's training, ``chain_training``
(a ``ChainTraining``): the loss its data term (nerfacto's MSE, Mip-NeRF
360's Charbonnier) + ``INTERLEVEL_LOSS_WEIGHT`` x the interlevel loss
(``losses/interlevel.py``) + ``distortion_loss_weight`` x the interval
distortion of the field's weights, the gradients clipped to its global
norm where it names one (a scale computed and applied on the device,
``clip_grad_norm_``), and RAdam at its one group and learning rate. The proposal levels take part in the backward and the
update only on the steps the chain's ``update_due`` names from
``state["proposal_since"]`` (steps since their last update, reset by an
update, one more after every step; every step for Mip-NeRF 360); on the
others their leaves keep their values and moments. The step count of
RAdam's rectifier stays the state's one counter.

With a ``mesh`` (``parallel/shard.py::make_sharded_train_step``) the step
is the JAX global-view step: the batch is this data rank's share, the
draws are the global batch's (each rank renders with its slice,
``_local_draws``), the per-ray outputs the losses read are gathered over
the data axis (``_LOSS_OUTPUTS``), so every rank computes the one loss of
the global batch, its masked means, k-means frame, pairs and controller
decision included, and the gradients are summed over the data axis before
RAdam. The terms that read only the table (TV, table decay) enter the
gradient on data rank 0 alone, so that the sum counts them once; with a
model axis each rank computes them on its own levels and sums their values
over the model axis (``collectives.model_sum``).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from indoor_nerf_tpu_torch.losses.distortion import (
    distortion_loss,
    interval_distortion,
)
from indoor_nerf_tpu_torch.losses.interlevel import interlevel_loss
from indoor_nerf_tpu_torch.losses.quantization import (
    QuantState,
    acaq_controller_update,
    init_quant_state,
)
from indoor_nerf_tpu_torch.losses.priors import (
    PriorConfig,
    combine_structural_losses,
    draw_priors,
)
from indoor_nerf_tpu_torch.models.field import (
    init_field_params,
    sigma_query,
)
from indoor_nerf_tpu_torch.ops.blockhash import block_tv_loss, draw_tv_rows
from indoor_nerf_tpu_torch.ops.occupancy import (
    OccState,
    draw_occupancy_update,
    init_occupancy,
    occupancy_update,
)
from indoor_nerf_tpu_torch.ops.rays import ndc_rays
from indoor_nerf_tpu_torch.ops.tv import (
    draw_tv_origins,
    patch_depth_regularizer,
    total_variation_loss,
)
from indoor_nerf_tpu_torch.parallel.collectives import (
    DATA,
    MODEL,
    all_reduce_,
    gather_rays,
    model_sum,
)
from indoor_nerf_tpu_torch.render import proposal
from indoor_nerf_tpu_torch.render.renderer import RenderConfig, draw_render, render_rays
from indoor_nerf_tpu_torch.train.optim import (
    RAdamHyper,
    exp_decay_lr,
    init_radam_state,
    mipnerf360_hyper_fn,
    mipnerf360_lr,
    named_leaves,
    nerfacto_hyper_fn,
    pocketnerf_hyper_fn,
    radam_update,
)
from indoor_nerf_tpu_torch.utils.spans import span

TrainState = Dict[str, Any]
# The proposal chains' weight of the interlevel loss (nerfstudio's
# interlevel_loss_mult, multinerf's interlevel_loss_mult).
INTERLEVEL_LOSS_WEIGHT = 1.0
# multinerf's guard on the clip's division (float32's epsilon).
_CLIP_EPS = float(torch.finfo(torch.float32).eps)
# multinerf's gradient clip and the Charbonnier padding of its data loss
# (internal/configs.py defaults).
MIP_GRAD_MAX_NORM = 1e-3
MIP_CHARB_PADDING = 1e-3


def mse_data_loss(rgb: torch.Tensor, target: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the loss's data term, the MSE the PSNR reads): the MSE twice."""
    mse = torch.mean((rgb - target) ** 2)
    return mse, mse


def charbonnier_data_loss(rgb: torch.Tensor, target: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the mean Charbonnier ``sqrt(x^2 + MIP_CHARB_PADDING^2)``, the
    MSE)."""
    diff = rgb - target
    sq = diff * diff
    return (torch.mean(torch.sqrt(sq + MIP_CHARB_PADDING ** 2)),
            torch.mean(sq))


@dataclasses.dataclass(frozen=True)
class ChainTraining:
    """How a proposal-chain model trains, beside its render chain
    (``RenderConfig.chain``): the data term ``data_loss(rgb, target) ->
    (term, mse)``, the learning rate ``learning_rate(lrate, lrate_decay,
    step)``, the one optimizer group ``hyper_fn`` and the global norm the
    gradients are clipped to (None: no clip)."""

    learning_rate: Callable[[float, int, int], float]
    hyper_fn: Callable[[str], RAdamHyper]
    data_loss: Callable = mse_data_loss
    grad_max_norm: Optional[float] = None


NERFACTO_TRAINING = ChainTraining(learning_rate=exp_decay_lr,
                                  hyper_fn=nerfacto_hyper_fn)
MIPNERF360_TRAINING = ChainTraining(learning_rate=mipnerf360_lr,
                                    hyper_fn=mipnerf360_hyper_fn,
                                    data_loss=charbonnier_data_loss,
                                    grad_max_norm=MIP_GRAD_MAX_NORM)


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
    # The A-CAQ bitwidth controller (with a quantized field).
    use_acaq: bool = False
    acaq_start_iter: int = 1000
    acaq_interval: int = 10
    priors: PriorConfig = PriorConfig()
    # The --reg_views patches' depth smoothness (0 = off): patches of
    # reg_patch_size^2 rays, "tv" (first differences of depth) or
    # "planar" (second differences of disparity), from reg_start_iter on.
    reg_patch_size: int = 8
    reg_depth_tv_weight: float = 0.0
    reg_mode: str = "tv"
    reg_start_iter: int = 0
    # A proposal-chain model's training (with ``render.chain``).
    chain_training: Optional[ChainTraining] = None


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
                     ema: bool = False,
                     quant: Optional[QuantState] = None) -> TrainState:
    """A train state around ``params`` (every leaf made trainable), zero
    RAdam moments, the grid ``occ``, the quantizer state ``quant`` (None
    for an unquantized field), fresh counters and, with ``ema``, the params
    EMA starting at ``params``."""
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
        "quant": quant,
        "step": 0,
        "best_loss": inf.clone(),
        "loss_ema": inf.clone(),
        "loss_ema_slow": inf.clone(),
        # EMA of A-CAQ's paired inflation ratio (MDL mode), updated on
        # controller steps only.
        "infl_ema": inf.clone(),
    }


def init_quant(config: TrainConfig, device=None) -> Optional[QuantState]:
    """A fresh quantizer state for a quantized field, with one grid
    quantizer per level and one activation quantizer per hidden sigma layer
    (JAX train/step.py:128-140); None otherwise."""
    fc = config.render.field
    if not fc.use_quantization:
        return None
    grid = fc.grid if fc.grid is not None else fc.block_grid
    return init_quant_state(dataclasses.replace(
        fc.quant, n_embed_levels=grid.n_levels,
        n_act_quantizers=fc.num_layers - 1), device)


def init_train_state(generator: torch.Generator, config: TrainConfig,
                     device=None) -> TrainState:
    """Fresh train state: seeded params, zero moments, a fully occupied
    grid, and the params EMA where ``config.ema_decay > 0``; a
    proposal-chain model's params and its proposal-update counter
    ``proposal_since`` with ``render.chain``."""
    chain = config.render.chain
    if chain is not None:
        params = chain.init_params(generator, config.render.field, device)
    else:
        params = init_field_params(generator, config.render.field, device)
    occ = (init_occupancy(config.render.occupancy, device)
           if config.render.occupancy is not None else None)
    state = make_train_state(params, occ, ema=config.ema_decay > 0.0,
                             quant=init_quant(config, device))
    if chain is not None:
        state["proposal_since"] = 0
    return state


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


def acaq_active(config: TrainConfig, step: int) -> bool:
    """Whether step ``step`` runs the A-CAQ controller: a quantized field
    with ``use_acaq``, from ``acaq_start_iter`` on, every ``acaq_interval``
    steps (the JAX ``lax.cond``, :486-492)."""
    return (config.use_acaq and config.render.field.use_quantization
            and step >= config.acaq_start_iter
            and step % config.acaq_interval == 0)


def _acaq_controller(state: TrainState, img_loss: torch.Tensor,
                     fp_loss: Optional[torch.Tensor], qc
                     ) -> Tuple[QuantState, torch.Tensor]:
    """The controller's signal and one controller update (JAX :413-484),
    after the loss EMAs. MDL mode (no ``target_metric``): the symmetric
    deviation ``max(r, 1/r)`` of the paired ratio r = quantized / bypassed
    loss of this batch, folded into ``infl_ema`` (decay
    ``fp_ref_ema_decay``; adopted while infinite), the trajectory ratio
    ``loss_ema / loss_ema_slow``, and ``max(infl_ema, traj, 1)`` against a
    reference of 1. MGL mode: ``loss_ema`` against the target. Returns
    (quant state, infl_ema)."""
    infl_ema = state["infl_ema"]
    if fp_loss is not None:
        ratio = img_loss / torch.clamp_min(fp_loss, 1e-30)
        dev = torch.maximum(ratio, 1.0 / torch.clamp_min(ratio, 1e-30))
        d_fp = qc.fp_ref_ema_decay
        infl_ema = torch.where(torch.isinf(infl_ema), dev,
                               d_fp * infl_ema + (1.0 - d_fp) * dev)
        traj = state["loss_ema"] / torch.clamp_min(state["loss_ema_slow"],
                                                   1e-30)
        current = torch.clamp_min(torch.maximum(infl_ema, traj), 1.0)
    else:
        current = state["loss_ema"]
    quant, _ = acaq_controller_update(state["quant"], current, 1.0, qc)
    return quant, infl_ema


def reg_active(config: TrainConfig, n_reg_rays: int) -> bool:
    """Whether a step renders ``n_reg_rays`` patch rays: a positive
    ``reg_depth_tv_weight`` and a batch that carries them."""
    return config.reg_depth_tv_weight > 0 and n_reg_rays > 0


def draw_step(generator: torch.Generator, config: TrainConfig, step: int,
              n_rays: int, with_coords: bool = False,
              n_reg_rays: int = 0) -> Dict[str, Any]:
    """Every draw step ``step`` takes: the render's (``draw_render``), the TV
    rows (block grid) or cube origins (hash grid) while TV is on, the
    priors' (``draws["priors"]``, ``draw_priors``; ``with_coords`` where the
    batch carries ``spatial_coords``) once they are active, the grid
    refresh's on refresh steps and, last, the patch render's
    (``draws["reg"]``, for the ``n_reg_rays`` patch rays of ``reg_active``):
    a step without patches draws what it drew before they came."""
    with span("draw"):
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
            cells, jitter = draw_occupancy_update(generator,
                                                  config.render.occupancy)
            draws["occ_cells"], draws["occ_jitter"] = cells, jitter
        if reg_active(config, n_reg_rays):
            draws["reg"] = draw_render(generator, n_reg_rays, config.render)
        return draws


# The draws of draw_render: one row per ray, sliced per data rank.
_RENDER_DRAWS = ("t_rand", "u", "sigma_noise", "sigma_noise1")
# The per-ray render outputs the step's losses read, gathered over the data
# axis of a sharded step.
_LOSS_OUTPUTS = ("rgb_map", "sparsity_loss", "rgb0", "sparsity_loss0",
                 "weights", "z_vals", "depth_map", "normal_map", "acc_map")


def _ray_slice(draws: Dict[str, Any], index: int, n: int) -> Dict[str, Any]:
    return {k: (v[index * n:(index + 1) * n] if k in _RENDER_DRAWS else v)
            for k, v in draws.items()}


def _local_draws(draws: Dict[str, Any], mesh, n: int, n_reg: int
                 ) -> Dict[str, Any]:
    """The global batch's draws with each per-ray draw cut to this data
    rank's ``n`` rays (and the patch render's to its ``n_reg``)."""
    d = mesh.index(DATA)
    out = _ray_slice(draws, d, n)
    if "reg" in draws:
        out["reg"] = _ray_slice(draws["reg"], d, n_reg)
    return out


def _gather_outputs(out: Dict[str, torch.Tensor], mesh
                    ) -> Dict[str, torch.Tensor]:
    """The outputs the losses read, over the global batch."""
    return {k: gather_rays(v, mesh) for k, v in out.items()
            if k in _LOSS_OUTPUTS}


def _table_terms_table(params: Dict[str, Any], mesh) -> Optional[torch.Tensor]:
    """The table the table-only terms read: detached on data ranks other
    than 0, whose gradient sum would count those terms again."""
    table = params.get("table")
    if table is not None and mesh is not None and mesh.index(DATA) != 0:
        return table.detach()
    return table


def _tv_term(table: torch.Tensor, fc, draws: Dict[str, Any], mesh
             ) -> torch.Tensor:
    """The grid's TV over the step's drawn rows or cubes; with a model axis
    this rank's levels (a local table), summed over the model axis."""
    m = 1 if mesh is None else mesh.size(MODEL)
    if m == 1:
        if fc.i_embed == 1:
            return total_variation_loss(table, fc.grid, draws["tv_origins"])
        return block_tv_loss(table, fc.block_grid, draws["tv_rows"])
    j = mesh.index(MODEL)
    if fc.i_embed == 1:
        g = fc.grid
        lp = g.n_levels // m
        tv = total_variation_loss(table, g, draws["tv_origins"],
                                  levels=range(j * lp, (j + 1) * lp),
                                  row_offset=j * lp * g.table_size)
    else:
        g = fc.block_grid
        lp = g.n_levels // m
        rows = draws["tv_rows"].reshape(g.n_levels, -1)[j * lp:(j + 1) * lp]
        tv = block_tv_loss(table, dataclasses.replace(g, n_levels=lp),
                           rows.reshape(-1) - j * lp * g.rows_per_level)
    return model_sum(tv, mesh)


def _decay_term(table: torch.Tensor, fc, mesh) -> torch.Tensor:
    """The fine-level table decay, sum_l 2^(l - (L-1)) * mean(table_l^2);
    with a model axis over this rank's levels, summed over the model
    axis."""
    g = fc.block_grid if fc.i_embed == 3 else fc.grid
    L = g.n_levels
    m = 1 if mesh is None else mesh.size(MODEL)
    lo = 0 if mesh is None else mesh.index(MODEL) * (L // m)
    per_level = torch.mean(table.reshape(L // m, -1) ** 2, dim=1)
    # Level l weighs 2^(l - (L-1)): the finest 1, each coarser half.
    decay = sum(per_level[l] * 2.0 ** (lo + l - (L - 1))
                for l in range(L // m))
    return decay if m == 1 else model_sum(decay, mesh)


def _view_bias(params: Dict[str, Any], fc, img_idx: Optional[torch.Tensor]
               ) -> Optional[torch.Tensor]:
    """The appearance latent rows of the batch's images ``[N, D]`` (JAX
    :218-225), or None without appearance latents. The gradient of the
    gather is dense over the table, as ``jnp.take``'s is, so RAdam's
    moments of the rows the batch did not sample decay as in JAX."""
    if fc.n_appearance > 0 and fc.use_viewdirs and img_idx is not None:
        return params["appearance"][img_idx.long()]
    return None


def _patch_smoothness(state: TrainState, batch: Dict[str, torch.Tensor],
                      config: TrainConfig, draws: Dict[str, torch.Tensor],
                      mesh=None) -> torch.Tensor:
    """The patches' depth smoothness (JAX :294-330): the patch rays
    rendered in training mode through the step's params, occupancy grid
    and quantizer state, viewdirs of the world rays, NDC where the render
    asks for it, and no appearance latent; the calibration the render
    returns is dropped (the quantizers track the image rays alone)."""
    rc = config.render
    reg_o, reg_d = batch["reg_rays_o"], batch["reg_rays_d"]
    reg_vd = None
    if rc.field.use_viewdirs:
        reg_vd = reg_d / torch.linalg.norm(reg_d, dim=-1, keepdim=True)
    if rc.ndc:
        Hn, Wn, focal_n = config.ndc_hwf
        reg_o, reg_d = ndc_rays(Hn, Wn, focal_n, 1.0, reg_o, reg_d)
    out, _ = render_rays(state["params"], reg_o, reg_d, reg_vd,
                         config.near * torch.ones_like(reg_d[..., :1]),
                         config.far * torch.ones_like(reg_d[..., :1]), rc,
                         occ_state=state["occ"], step=state["step"],
                         draws=draws, quant_state=state.get("quant"),
                         train=True)
    if mesh is not None:
        out = _gather_outputs(out, mesh)
    return patch_depth_regularizer(out["depth_map"], out["acc_map"],
                                   config.reg_patch_size, config.near,
                                   config.far, config.reg_mode)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               config: TrainConfig, generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, Any]] = None,
               prior_weights: Optional[Dict[str, float]] = None,
               mesh=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step over the ``[N]`` rays of ``batch``
    (``rays_o``, ``rays_d``, ``target``, each ``[N, 3]``, and optionally
    ``spatial_coords`` ``[N, 2]``, the pixels' (row, col), which the
    priors' consistency term pairs by, ``img_idx`` ``[N]``, the rays'
    images, which the appearance latents read, and ``reg_rays_o``,
    ``reg_rays_d`` ``[P * patch^2, 3]``, the ``--reg_views`` patch rays).

    The loss is MSE + ``sparse_loss_weight`` * the summed ray entropy (with
    a fine pass, of both passes: the coarse pass's MSE and entropy are
    added) + ``tv_loss_weight`` * the grid's TV (``block_tv_loss`` or the
    hash grid's ``total_variation_loss``) while ``step <= tv_cutoff_iter``
    (JAX :235-266), + the distortion (:270-274), + the table decay
    (:281-292), + ``reg_depth_tv_weight`` * the patches' depth smoothness
    from ``reg_start_iter`` on (:294-330), + the structural priors once
    active, at
    ``prior_ramp_weights`` of the host's base ``prior_weights``
    (``default_prior_weights`` where None; :331-368). Then RAdam at the
    learning rate of the optimizer's step before its increment (:383), the
    loss EMAs (:392-411), on every ``update_interval``-th step (step 0
    included) the grid refresh, which reads the UPDATED params (:494-509),
    and the params EMA (:511-517). With a quantized field the render's
    queries fake-quantize and calibrate (``state["quant"]``), and on
    controller steps (``acaq_active``) the A-CAQ controller moves the bits
    (:413-492). Returns (state, metrics{loss, img_loss, psnr, lr}, with a
    positive ``reg_depth_tv_weight`` the patches' ungated
    ``reg_depth_tv``, and, on steps with the priors, the ``structural_*``
    diagnostics of ``combine_structural_losses``); ``state`` is updated in
    place. ``mesh``: the sharded step of ``make_sharded_train_step`` (the
    module docstring); ``batch`` is then this data rank's rays and
    ``draws``, where given, the global batch's. The whole step is one
    ``train_step`` span, the unit of ``utils/spans.py``."""
    with span("train_step"):
        return _train_step(state, batch, config, generator, draws,
                           prior_weights, mesh)


def clip_grad_norm_(grads, max_norm: float) -> None:
    """Scale ``grads`` (a sequence; None entries skipped) in place by
    ``min(1, max_norm / (eps + |g|))``, ``|g|`` their global norm
    (multinerf's ``clip_gradients``): the norm, the scale and the products
    stay on the device, so the host does not wait."""
    gs = [g for g in grads if g is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
    scale = torch.clamp_max(max_norm / (norm + _CLIP_EPS), 1.0)
    torch._foreach_mul_(gs, scale)


def _train_step_proposal(state, batch, config, generator, draws):
    """A proposal-chain model's step (the module docstring)."""
    rc = config.render
    chain, training = rc.chain, config.chain_training
    step = state["step"]
    params = state["params"]
    rays_o, rays_d, target = batch["rays_o"], batch["rays_d"], batch["target"]
    if draws is None:
        draws = draw_step(generator, config, step, rays_o.shape[0])
    update = chain.update_due(step, state["proposal_since"])
    near = config.near * torch.ones_like(rays_d[..., :1])
    far = config.far * torch.ones_like(rays_d[..., :1])
    out, _ = render_rays(params, rays_o, rays_d, None, near, far, rc,
                         step=step, draws=draws, train=True,
                         update_proposals=update,
                         camera_idx=batch.get("img_idx"))
    data_loss, img_loss = training.data_loss(out["rgb_map"], target)
    with span("interlevel"):
        interlevel = interlevel_loss(out["edges"], out["weights"],
                                     out["proposal_edges"],
                                     out["proposal_weights"])
    distortion = interval_distortion(out["edges"], out["weights"])
    loss = (data_loss + INTERLEVEL_LOSS_WEIGHT * interlevel
            + config.distortion_loss_weight * distortion)
    leaves = named_leaves(params)
    wrt = [k for k in leaves if update or not k.startswith("proposal_")]
    with span("backward"):
        # A leaf the loss does not reach gets None, which RAdam counts as
        # zero.
        grads = torch.autograd.grad(loss, [leaves[k] for k in wrt],
                                    allow_unused=True)
    lr = training.learning_rate(config.lrate, config.lrate_decay,
                                state["opt"]["step"])
    with span("optimizer"):
        if training.grad_max_norm is not None:
            clip_grad_norm_(grads, training.grad_max_norm)
        radam_update({k: leaves[k] for k in wrt}, dict(zip(wrt, grads)),
                     state["opt"], lr, training.hyper_fn)
    if update:
        proposal.count_update()
    state["proposal_since"] = (0 if update else state["proposal_since"]) + 1
    il = img_loss.detach()
    state["step"] = step + 1
    return state, {"loss": loss.detach(), "img_loss": il,
                   "psnr": -10.0 * torch.log(il) / math.log(10.0), "lr": lr,
                   "interlevel": interlevel.detach(),
                   "distortion": distortion.detach(),
                   "proposal_update": update}


def _train_step(state, batch, config, generator, draws, prior_weights, mesh):
    rc = config.render
    if rc.chain is not None:
        if mesh is not None:
            raise NotImplementedError(f"{rc.chain.name} trains on one "
                                      "device: no sharded step")
        return _train_step_proposal(state, batch, config, generator, draws)
    fc = rc.field
    step = state["step"]
    params = state["params"]
    rays_o, rays_d, target = batch["rays_o"], batch["rays_d"], batch["target"]
    spatial_coords = batch.get("spatial_coords")
    reg_o = batch.get("reg_rays_o")
    n_reg = 0 if reg_o is None else reg_o.shape[0]
    n_data = 1 if mesh is None else mesh.size(DATA)
    if draws is None:
        draws = draw_step(generator, config, step, rays_o.shape[0] * n_data,
                          spatial_coords is not None, n_reg * n_data)
    ray_draws = (draws if mesh is None
                 else _local_draws(draws, mesh, rays_o.shape[0], n_reg))
    view_bias = _view_bias(params, fc, batch.get("img_idx"))

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

    out, new_quant = render_rays(params, rays_o, rays_d, viewdirs, near, far,
                                 rc, occ_state=state["occ"], step=step,
                                 draws=ray_draws,
                                 quant_state=state.get("quant"),
                                 train=True, view_bias=view_bias)
    if mesh is not None:
        out = _gather_outputs(out, mesh)
        target = gather_rays(target, mesh)
        if spatial_coords is not None:
            spatial_coords = gather_rays(spatial_coords, mesh)
        near = config.near * torch.ones_like(target[..., :1])
        far = config.far * torch.ones_like(target[..., :1])
    img_loss = torch.mean((out["rgb_map"] - target) ** 2)
    loss = img_loss
    sparsity = torch.sum(out["sparsity_loss"])
    if "rgb0" in out:
        loss = loss + torch.mean((out["rgb0"] - target) ** 2)
        sparsity = sparsity + torch.sum(out["sparsity_loss0"])
    loss = loss + config.sparse_loss_weight * sparsity
    table = _table_terms_table(params, mesh)
    if _tv_active(config, step):
        with span("tv"):
            tv = _tv_term(table, fc, draws, mesh)
        loss = loss + config.tv_loss_weight * tv
    if config.distortion_loss_weight > 0:
        loss = loss + config.distortion_loss_weight * distortion_loss(
            out["weights"], out["z_vals"], near, far)
    if config.table_decay_weight > 0 and fc.uses_grid:
        loss = loss + config.table_decay_weight * _decay_term(table, fc, mesh)
    reg_tv = None
    if reg_active(config, n_reg):
        with span("reg_patches"):
            reg_tv = _patch_smoothness(state, batch, config,
                                       ray_draws["reg"], mesh)
        gate = 1.0 if step >= config.reg_start_iter else 0.0
        loss = loss + config.reg_depth_tv_weight * gate * reg_tv
    diag = {}
    if priors_active(config, step):
        with span("priors"):
            structural, diag = combine_structural_losses(
                out["depth_map"], out["normal_map"], spatial_coords,
                prior_ramp_weights(config, step, prior_weights),
                draws["priors"], config.priors)
        loss = loss + structural

    leaves = named_leaves(params)
    # A batch without img_idx does not reach the appearance table: it gets
    # no gradient, which radam_update counts as zero, as JAX's is.
    wrt = [k for k in leaves if k != "appearance" or view_bias is not None]
    with span("backward"):
        grads = torch.autograd.grad(loss, [leaves[k] for k in wrt])
    if mesh is not None:
        for g in grads:
            all_reduce_(g, mesh, DATA)
    fp_loss = None
    if acaq_active(config, step) and fc.quant.target_metric is None:
        # The MDL anchor: this batch's loss without any quantizer, on the
        # same rays, draws and (pre-update) params (JAX :420-434).
        with torch.no_grad(), span("acaq_fp_forward"):
            out_fp, _ = render_rays(params, rays_o, rays_d, viewdirs,
                                    near[:rays_o.shape[0]],
                                    far[:rays_o.shape[0]], rc,
                                    occ_state=state["occ"], step=step,
                                    draws=ray_draws, train=True,
                                    view_bias=view_bias)
            fp_loss = torch.mean(
                (gather_rays(out_fp["rgb_map"], mesh) - target) ** 2)
        del out_fp
    lr = exp_decay_lr(config.lrate, config.lrate_decay, state["opt"]["step"])
    with span("optimizer"):
        radam_update(leaves, dict(zip(wrt, grads)), state["opt"], lr,
                     pocketnerf_hyper_fn)

    il = img_loss.detach()
    d = fc.quant.loss_ema_decay
    d_slow = 1.0 - (1.0 - d) / 10.0
    ema = state["loss_ema"]
    state["loss_ema"] = torch.where(torch.isinf(ema), il, d * ema + (1.0 - d) * il)
    slow = state["loss_ema_slow"]
    state["loss_ema_slow"] = torch.where(torch.isinf(slow), il,
                                         d_slow * slow + (1.0 - d_slow) * il)
    state["best_loss"] = torch.minimum(state["best_loss"], state["loss_ema"])
    state["quant"] = new_quant
    if acaq_active(config, step):
        state["quant"], state["infl_ema"] = _acaq_controller(
            state, il, fp_loss, fc.quant)

    if _refresh_due(config, step):
        mlp_name = "fine" if "fine" in params else "coarse"
        with torch.no_grad(), span("occ_update"):
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
    if config.reg_depth_tv_weight > 0:
        metrics["reg_depth_tv"] = (il.new_zeros(()) if reg_tv is None
                                   else reg_tv.detach())
    metrics.update({f"structural_{k}": v.detach() for k, v in diag.items()})
    return state, metrics
