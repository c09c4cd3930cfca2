"""RAdam with the reference's two param groups (train/optim.py of the JAX
package), as plain tensor code over a ``{name: tensor}`` dict.

Not ``torch.optim.RAdam``, whose semantics differ from the JAX one (and
the reference's, PocketNeRF/radam.py) in three ways: it takes an
un-rectified step while the rectification term N_sma is <= 5, where this
one leaves the parameter unchanged; its weight decay is L2 by default, not
decoupled; and it bias-corrects the denominator separately, where this one
keeps the ``(1 - beta2^t)`` factor inside the rectified step size.

The scalar schedule (lr, N_sma, the rectified step) is computed in float32
on the host, as the JAX package computes it in float32 on the device; the
step counter is a host integer. Moments and parameters are updated in
place, which saves a copy of each (the table's are 64 MiB at the flagship).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

Leaves = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RAdamHyper:
    """Static RAdam hyperparameters for one param group."""

    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-8
    weight_decay: float = 0.0


def named_leaves(params: Dict[str, object]) -> Leaves:
    """The params' tensors by name: ``"table"``, ``"coarse.sigma_net.0.w"``,
    ... (the JAX pytree path joined by dots)."""
    out: Leaves = {}
    for key, value in params.items():
        if isinstance(value, nn.Module):
            for name, t in value.named_parameters():
                out[f"{key}.{name}"] = t
        else:
            out[key] = value
    return out


def init_radam_state(leaves: Leaves) -> Dict[str, object]:
    return {"mu": {k: torch.zeros_like(v) for k, v in leaves.items()},
            "nu": {k: torch.zeros_like(v) for k, v in leaves.items()},
            "step": 0}


def exp_decay_lr(lrate: float, lrate_decay: int, step: int) -> float:
    """lr = lrate * 0.1^(step / (lrate_decay * 1000)), in float32
    (reference: run_nerf.py:1289-1293)."""
    decay_steps = np.float32(lrate_decay * 1000.0)
    return float(np.float32(lrate)
                 * np.power(np.float32(0.1), np.float32(step) / decay_steps))


def pocketnerf_hyper_fn(name: str) -> RAdamHyper:
    """The reference's two param groups (run_nerf.py:281-285): the table
    gets eps 1e-15 and no weight decay; everything else weight decay 1e-6
    and the default eps."""
    if name == "table":
        return RAdamHyper(eps=1e-15, weight_decay=0.0)
    return RAdamHyper(eps=1e-8, weight_decay=1e-6)


def _rectified_step(h: RAdamHyper, t: int):
    """(adaptive?, rect) for step ``t`` (1-based), in float32 as JAX :81-95."""
    f32 = np.float32
    tf = f32(t)
    beta2_t = np.power(f32(h.beta2), tf)
    n_sma_max = f32(2.0 / (1.0 - h.beta2) - 1.0)
    n_sma = n_sma_max - f32(2.0) * tf * beta2_t / (f32(1.0) - beta2_t)
    rect = np.sqrt(np.maximum(
        (f32(1.0) - beta2_t)
        * (n_sma - f32(4.0)) / (n_sma_max - f32(4.0))
        * (n_sma - f32(2.0)) / n_sma
        * n_sma_max / (n_sma_max - f32(2.0)), f32(0.0)))
    rect = rect / (f32(1.0) - np.power(f32(h.beta1), tf))
    return bool(n_sma >= f32(5.0)), f32(rect)


@torch.no_grad()
def radam_update(leaves: Leaves, grads: Dict[str, Optional[torch.Tensor]],
                 state: Dict[str, object], lr: float,
                 hyper_fn: Callable[[str], RAdamHyper] = pocketnerf_hyper_fn
                 ) -> None:
    """One RAdam step over ``leaves`` in place (JAX ``radam_update``,
    :60-127). A missing gradient counts as zero. While N_sma < 5 (the first
    5 steps at beta2 0.99) the moments accumulate and the parameters stay
    unchanged; then ``p -= wd*lr*p`` (decoupled) and
    ``p -= lr*rect * mu / (sqrt(nu) + eps)``."""
    t = state["step"] + 1
    lr32 = np.float32(lr)
    for name, p in leaves.items():
        g = grads.get(name)
        if g is None:
            g = torch.zeros_like(p)
        h = hyper_fn(name)
        mu, nu = state["mu"][name], state["nu"][name]
        nu.mul_(h.beta2).add_(g * g * (1.0 - h.beta2))
        mu.mul_(h.beta1).add_(g * (1.0 - h.beta1))
        adaptive, rect = _rectified_step(h, t)
        if not adaptive:
            continue
        if h.weight_decay != 0.0:
            p.sub_(p * float(np.float32(h.weight_decay) * lr32))
        p.sub_(mu * float(lr32 * rect) / (torch.sqrt(nu) + h.eps))
    state["step"] = t
