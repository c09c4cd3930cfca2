"""A-CAQ: learned-bitwidth fake quantization and its bitwidth controller
(losses/quantization.py of the JAX package; reference:
PocketNeRF/quantization.py and the controller of run_nerf.py:1182-1286).

The quantizer "parameters" (``soft_bits``, ``range_scale``, ``v_max``)
receive no gradient: the straight-through estimator ``x + (xq - x).detach()``
detaches every term that depends on them. So they are plain state, a dict
of device tensors with the JAX state's keys and shapes (``init_quant_state``:
one asymmetric quantizer per grid level under ``"embed"``, one per hidden
sigma activation under ``"act"``, one symmetric one for the first sigma
weight under ``"weight"``), updated by the running calibration of every
training call (``calibrate``) and by the controller every
``acaq_interval`` steps (``acaq_controller_update``). Every update is
tensor arithmetic with ``torch.where`` selects, so none waits for the card.

The JAX package departs from the reference in four places, and so does the
port (DIVERGENCES.md): the range is live, expanded at once and shrunk by an
EMA (#33's rationale for the quantizers: a frozen first-batch range clamps
what training learns later); the zero point is anchored at the minimum; the
MDL tolerance is a knob with default 1.0 (#35); the clip bounds follow the
scale's bitwidth, the scale guard is multiplicative and 24 bits or more pass
through (#37, #11).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from indoor_nerf_tpu_torch.ops.constants import device_constant
from indoor_nerf_tpu_torch.parallel.collectives import data_reduce_

QuantState = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantization hyperparameters (a copy of the JAX QuantConfig;
    reference defaults: quantization.py:73, run_nerf.py:678-713,
    hash_encoding.py:25 for the warmup)."""

    init_bits: float = 8.0
    min_bits: float = 2.0
    max_bits: float = 32.0
    n_embed_levels: int = 16
    n_act_quantizers: int = 1  # NeRFSmall num_layers - 1
    warmup_steps: int = 500  # the grid quantizer's warmup, in steps
    bit_penalty: float = 1e-3
    target_metric: Optional[float] = None  # MGL target; None = MDL mode
    acaq_interval: int = 10
    # Per-step decay of the image-loss EMA (the step's loss_ema; MGL mode's
    # smoothed current loss, and the fast side of MDL's trajectory ratio).
    loss_ema_decay: float = 0.99
    # Per-interval decay of the EMA of the paired inflation ratio (MDL).
    fp_ref_ema_decay: float = 0.9
    # MDL tolerance (DIVERGENCES.md #35): bits shrink while the worse of the
    # paired inflation and the trajectory ratio stays under it. The signal
    # is clamped at 1.0, so a tolerance below 1.0 would read permanent
    # inflation and ratchet bits to max_bits; __post_init__ refuses it.
    mdl_tolerance: float = 1.0

    def __post_init__(self):
        if self.mdl_tolerance < 1.0:
            raise ValueError(
                f"mdl_tolerance={self.mdl_tolerance} < 1.0: the MDL "
                "controller signal is clamped to >= 1.0, so tolerances "
                "below 1.0 silently ratchet bits to max_bits (the loss "
                "ratio always exceeds the 1.05x grow band). Use >= 1.0.")


def _group(shape, init_bits: float, symmetric: bool, device=None) -> QuantState:
    """One vectorized quantizer group (reference: quantization.py:73-95)."""
    def full(value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=device)

    g = {"soft_bits": full(init_bits), "range_scale": full(0.0002),
         "running_min": full(float("inf")), "running_max": full(float("-inf")),
         "calibrated": full(False, torch.bool)}
    if not symmetric:
        g["v_max"] = full(0.0001)
    return g


def init_quant_state(config: QuantConfig, device=None) -> QuantState:
    """The reference's quantizers: ``n_embed_levels`` asymmetric grid-level
    ones, ``n_act_quantizers`` asymmetric activation ones and one symmetric
    first-layer weight one (reference: hash_encoding.py:45-51,
    run_nerf_helpers.py:220-233)."""
    return {
        "embed": _group((config.n_embed_levels,), config.init_bits, False, device),
        "act": _group((config.n_act_quantizers,), config.init_bits, False, device),
        "weight": _group((), config.init_bits, True, device),
    }


def fake_quant_fixed(x: torch.Tensor, scale, zero_point, num_bits: int,
                     symmetric: bool = True, train: bool = True) -> torch.Tensor:
    """Fixed-bitwidth affine fake quantization with the STE (reference:
    quantization.py:6-62)."""
    if symmetric:
        qmin, qmax = -(2 ** (num_bits - 1)), 2 ** (num_bits - 1) - 1
    else:
        qmin, qmax = 0, 2 ** num_bits - 1
    x_scaled = x / scale
    if not symmetric:
        x_scaled = x_scaled + zero_point
    x_quant = torch.clamp(torch.round(x_scaled), qmin, qmax)
    x_dequant = (x_quant - zero_point) * scale
    if train:
        return x + (x_dequant - x).detach()
    return x_dequant


def calibrate(group: QuantState, x: torch.Tensor, symmetric: bool,
              momentum: float = 0.05) -> QuantState:
    """Running min/max calibration on ``x``: the first call adopts its
    range, later calls expand at once to cover it and shrink by an EMA
    (the JAX ``calibrate``; a frozen first-batch range collapses
    quantized training). ``calibrated`` flips on. Returns a new group."""
    x = x.detach()
    done = group["calibrated"]
    # The global batch's range, in a sharded step (parallel/shard.py).
    bmin = data_reduce_(torch.amin(x), dist.ReduceOp.MIN)
    bmax = data_reduce_(torch.amax(x), dist.ReduceOp.MAX)
    ema_min = (1.0 - momentum) * group["running_min"] + momentum * bmin
    ema_max = (1.0 - momentum) * group["running_max"] + momentum * bmax
    new_min = torch.where(done, torch.minimum(ema_min, bmin), bmin)
    new_max = torch.where(done, torch.maximum(ema_max, bmax), bmax)
    new = dict(group, running_min=new_min, running_max=new_max)
    if symmetric:
        max_abs = torch.maximum(torch.abs(new_min), torch.abs(new_max))
        new["range_scale"] = 2.0 * max_abs
    else:
        new["range_scale"] = new_max - new_min
        new["v_max"] = new_max
    new["calibrated"] = torch.ones_like(done)
    return new


def learned_fake_quant(x: torch.Tensor, group: QuantState, config: QuantConfig,
                       symmetric: bool, train: bool = True,
                       idx: Optional[int] = None) -> torch.Tensor:
    """LearnedBitwidthQuantizer.forward (reference: quantization.py:144-187):
    soft bits in training, rounded ones in evaluation; with ``idx`` the
    group's leaves are indexed (one of its vectorized quantizers)."""
    def get(v):
        return v if idx is None else v[idx]

    bits = torch.clamp(get(group["soft_bits"]), config.min_bits, config.max_bits)
    b = bits if train else torch.round(bits)
    # DIVERGENCES.md #37: the clip bounds follow the bitwidth the scale
    # uses (the reference's integer bounds beside a soft scale clamp up to
    # 29% of the range whenever soft > int, and the A-CAQ controller then
    # ratchets bits up).
    if symmetric:
        qmin = -torch.exp2(b - 1.0)
        qmax = torch.exp2(b - 1.0) - 1.0
        scale = get(group["range_scale"]) / torch.exp2(b - 1.0)
        zero_point = torch.zeros_like(scale)
    else:
        qmin = torch.zeros_like(b)
        qmax = torch.exp2(b) - 1.0
        scale = torch.clamp_min(get(group["range_scale"]), 1e-8) / (
            torch.exp2(b) - 1.0)
        # The zero point anchored at the minimum (the reference's v_max
        # anchor maps the top of a ReLU range to zero and kills training).
        zero_point = torch.round(torch.clamp(
            -get(group["running_min"]) / scale, qmin, qmax))
    # DIVERGENCES.md #11: a multiplicative guard; the reference's additive
    # 1e-8 dominates the true scale past ~24 bits and shrinks every value.
    safe_scale = torch.clamp_min(scale, 1e-30)
    x_quant = torch.clamp(torch.round(x / safe_scale + zero_point), qmin, qmax)
    x_dequant = (x_quant - zero_point) * safe_scale
    # At 24 bits and more the rounding is a no-op for f32 data: pass through.
    x_dequant = torch.where(bits >= 24.0, x, x_dequant)
    if train:
        return x + (x_dequant - x).detach()
    return x_dequant


def passthrough_quant(x: torch.Tensor) -> torch.Tensor:
    """No-op quantizer for A/B debugging (reference: quantization.py:197-208,
    whose bit_width reports 32)."""
    return x


PASSTHROUGH_BITS = 32.0


def flat_bits(state: QuantState) -> torch.Tensor:
    """Every soft bitwidth in the reference's controller order: the grid
    levels, the activations, the weight (JAX ``_flat_bits``; reference:
    run_nerf.py:1184-1194)."""
    return torch.cat([state["embed"]["soft_bits"], state["act"]["soft_bits"],
                      state["weight"]["soft_bits"][None]])


def average_bits(state: QuantState, config: QuantConfig) -> torch.Tensor:
    """Mean clamped bitwidth over all quantizers (FQR, reference:
    quantization.py:211-224)."""
    return torch.mean(torch.clamp(flat_bits(state), config.min_bits,
                                  config.max_bits))


def acaq_controller_update(state: QuantState, current_loss: torch.Tensor,
                           ref_loss, config: QuantConfig
                           ) -> Tuple[QuantState, torch.Tensor]:
    """One A-CAQ controller step (reference: run_nerf.py:1210-1252): with
    ``loss_ratio = current_loss / target`` (target: the MGL
    ``target_metric``, else ``ref_loss * mdl_tolerance``), every quantizer
    i of the flat order moves by ``delta = (-0.3 | -0.1 | +0.2 by the
    thresholds 0.95 / 1.05) - bit_penalty * bits / 8``, times the layer
    factor ``1 + (i - n/2) * 0.02``, clipped to [min_bits, max_bits].

    In MDL mode the step passes the hybrid signal max(paired inflation EMA,
    trajectory ratio, 1) as ``current_loss`` and 1 as ``ref_loss``
    (train/step.py; DIVERGENCES.md #33, #35). Returns (new state, target);
    the step calls it on controller steps only."""
    # The target as a tensor: PyTorch's CUDA division by a Python number
    # multiplies by its rounded reciprocal.
    if config.target_metric is not None:
        target = torch.full_like(current_loss, config.target_metric)
    else:
        target = ref_loss * config.mdl_tolerance
        if not isinstance(target, torch.Tensor):
            target = torch.full_like(current_loss, target)
    bits = flat_bits(state)
    n = bits.shape[0]
    loss_ratio = current_loss / target
    base_delta = torch.where(loss_ratio < 0.95, -0.3,
                             torch.where(loss_ratio < 1.05, -0.1, 0.2))
    delta = base_delta - config.bit_penalty * bits / 8.0
    # In float32 op by op, as the JAX step computes it.
    f32 = np.float32
    layer_factor = device_constant(
        f32(1.0) + (np.arange(n, dtype=f32) - f32(n / 2.0)) * f32(0.02),
        torch.float32, bits.device)
    new_bits = torch.clamp(bits + delta * layer_factor, config.min_bits,
                           config.max_bits)
    n_embed = state["embed"]["soft_bits"].shape[0]
    n_act = state["act"]["soft_bits"].shape[0]
    new_state = dict(state)
    new_state["embed"] = dict(state["embed"], soft_bits=new_bits[:n_embed])
    new_state["act"] = dict(state["act"],
                            soft_bits=new_bits[n_embed:n_embed + n_act])
    new_state["weight"] = dict(state["weight"], soft_bits=new_bits[-1])
    return new_state, target
