"""The training step and RAdam.

Loss: the photometric MSE (of both passes on the hierarchical path) plus
``sparse_w`` times the summed entropy of the ray weights, the grid's TV
(only up to step 1000; no cell steps there) and, from the configured start
step, the structural priors at their ramped weights. Gradients by
autograd, then RAdam with PocketNeRF's two groups (the table: eps 1e-15, no
weight decay; the networks: eps 1e-8, decoupled weight decay 1e-6), the
parameters held while the rectification term is below 5, the learning
rate decayed by 0.1 every ``lrate_decay`` thousand steps. Every
``occ_interval``-th step then refreshes the occupancy grid from the
updated weights.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from nerfbench.reference import priors, render
from nerfbench.reference.spec import TV_CUTOFF, Spec

BETA1, BETA2 = 0.9, 0.99


def lr_at(spec: Spec, t: int) -> float:
    return float(np.float32(spec.lrate) * np.power(
        np.float32(0.1), np.float32(t) / np.float32(spec.lrate_decay * 1000.0)))


def rectified(t: int):
    """(adaptive, step factor) of RAdam's step ``t`` (1-based), float32."""
    f32 = np.float32
    b2t = np.power(f32(BETA2), f32(t))
    n_max = f32(2.0 / (1.0 - BETA2) - 1.0)
    n_sma = n_max - f32(2.0) * f32(t) * b2t / (f32(1.0) - b2t)
    rect = np.sqrt(np.maximum((f32(1.0) - b2t) * (n_sma - f32(4.0))
                              / (n_max - f32(4.0)) * (n_sma - f32(2.0)) / n_sma
                              * n_max / (n_max - f32(2.0)), f32(0.0)))
    return bool(n_sma >= f32(5.0)), f32(rect / (f32(1.0) - np.power(f32(BETA1), f32(t))))


@torch.no_grad()
def radam(params, grads, mu, nu, t: int, lr: float) -> None:
    adaptive, rect = rectified(t)
    lr32 = np.float32(lr)
    for k, p in params.items():
        g = grads[k]
        table = k == "table"
        eps, wd = (1e-15, 0.0) if table else (1e-8, 1e-6)
        nu[k].mul_(BETA2).add_(g * g * (1.0 - BETA2))
        mu[k].mul_(BETA1).add_(g * (1.0 - BETA1))
        if not adaptive:
            continue
        if wd:
            p.sub_(p * float(np.float32(wd) * lr32))
        p.sub_(mu[k] * float(lr32 * rect) / (torch.sqrt(nu[k]) + eps))


def prior_weights(spec: Spec, step: int) -> Dict[str, float]:
    f32 = np.float32
    ramp = np.clip(f32(step - spec.prior_start) / f32(spec.prior_ramp), 0.0, 1.0)
    factor = f32(0.1) + f32(0.9) * f32(ramp)
    return {k: float(f32(v) * factor) for k, v in spec.prior_weights.items()}


def loss_of(params, batch: Dict[str, torch.Tensor], draws, density, step: int,
            spec: Spec) -> torch.Tensor:
    if step <= TV_CUTOFF and spec.tv_w > 0:
        raise NotImplementedError("the reference holds no TV loss: cells "
                                  f"step past {TV_CUTOFF}")
    out = render.render_rays(params, batch["rays_o"], batch["rays_d"], spec,
                             density, step, draws)
    target = batch["target"]
    loss = torch.mean((out["rgb_map"] - target) ** 2)
    sparsity = out["sparsity"].sum()
    if "rgb0" in out:
        loss = loss + torch.mean((out["rgb0"] - target) ** 2)
        sparsity = sparsity + out["sparsity0"].sum()
    loss = loss + spec.sparse_w * sparsity
    if spec.priors and step >= spec.prior_start:
        loss = loss + priors.structural_loss(
            out["depth_map"], out["normal_map"], batch.get("spatial_coords"),
            prior_weights(spec, step), draws["priors"])
    return loss


def run_steps(params, batches: List[Dict[str, torch.Tensor]],
              draws: List[Dict], spec: Spec, step0: int, opt_step0: int,
              density: Optional[torch.Tensor]) -> Dict:
    """Train ``params`` (updated in place) from zero moments over the
    batches and draws of steps ``step0``, ``step0 + 1``, ...; the
    optimizer's counter starts at ``opt_step0``. Returns each step's loss,
    the first step's gradient norm per leaf and per row of the table, and
    the final density."""
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad_norms = [], None
    for i, (batch, dr) in enumerate(zip(batches, draws)):
        step = step0 + i
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_of(leaves, batch, dr, density, step, spec)
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        if grad_norms is None:
            grad_norms = {k: float(torch.linalg.norm(g)) for k, g in grads.items()}
            g = grads["table"]
            table_rows = torch.linalg.norm(g.reshape(g.shape[0], -1),
                                           dim=1).cpu().numpy()
        losses.append(float(loss.detach()))
        t = opt_step0 + i + 1
        radam(params, grads, mu, nu, t, lr_at(spec, t - 1))
        if spec.occupancy and step % spec.occ_interval == 0:
            density = render.occupancy_refresh(density, params, spec,
                                               dr["occ_cells"], dr["occ_jitter"])
    return {"losses": losses, "grad_norms": grad_norms,
            "table_rows": table_rows, "density": density}
