"""Operations and bytes of the logical work, and the chip's peaks.

The counts are of the operation the configuration asks for, whatever
implements it, so they stay valid when a later change fuses, replaces or
removes a kernel:

- the encode forward reads each point once (3 float32), writes each
  feature once (float32), and reads each table entry that some (point,
  level) interpolates from once, at the configuration's gather width
  (an entry: F features of one tile vertex of the block grid, or of one
  hash row); its operations are the interpolation's multiply-adds: per
  (point, level) 2 x 8 x F for the weighted sum and 2 x 8 for the corner
  weights;
- the encode backward reads each point and each cotangent entry once and
  writes the gradient of each touched table entry once (float32), with
  the same operations;
- the network's operations: 2 per multiply-add of each layer, three
  times over for a training step (forward, and the two products of the
  backward).

The entries a batch touches are counted from the batch's sample points
with the reference's own index math (``reference/grid.py``), not from the
program's layout. The least time of a piece of work is the larger of its
bytes over the memory bandwidth and its operations over the float32 peak.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Optional

import torch

from nerfbench.reference import grid
from nerfbench.reference.spec import Spec

# NVIDIA H100 SXM data sheet, dense: HBM3 bandwidth, and float32 outside the
# tensor cores (the configurations run float32 with TF32 off).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def mlp_flops_per_sample(spec: Spec) -> int:
    """Forward operations of NeRFSmall (and its normal net) per sample."""
    L, F, h, geo = spec.n_levels, spec.n_features, spec.hidden, spec.geo
    macs = L * F * h + h * (1 + geo)  # sigma net
    macs += (16 + geo) * h + h * h + h * 3  # colour net
    if spec.normals:
        macs += geo * (h // 2) + (h // 2) * 3
    return 2 * macs


def interp_flops(spec: Spec) -> int:
    """Operations of one (point, level) interpolation."""
    return 2 * 8 * spec.n_features + 2 * 8


def encode_work(n_points: int, touched: int, spec: Spec, backward: bool
                ) -> Dict[str, float]:
    """Bytes and operations of one encode (forward, or backward into the
    table) of ``n_points`` points whose interpolations touch ``touched``
    table entries."""
    L, F = spec.n_levels, spec.n_features
    pl = n_points * L
    if backward:
        nbytes = n_points * 12 + pl * F * 4 + touched * F * 4
    else:
        width = 2 if (spec.grid == "block" and spec.gather_bf16) else 4
        nbytes = n_points * 12 + pl * F * 4 + touched * F * width
    return {"bytes": float(nbytes), "flops": float(pl * interp_flops(spec))}


def least_seconds(work: Dict[str, float]) -> float:
    return max(work["bytes"] / PEAK_BYTES_PER_S, work["flops"] / PEAK_F32_FLOPS)


def touched_count(points: torch.Tensor, spec: Spec, block: int = 1 << 18) -> int:
    """How many table entries the interpolation of ``points`` ``[N, 3]``
    reads (each counted once)."""
    seen = torch.zeros(grid.entry_count(spec), dtype=torch.bool,
                       device=points.device)
    for s in range(0, points.shape[0], block):
        grid.touched_entries(points[s:s + block], spec, seen)
    return int(seen.sum())


def step_flops(spec: Spec, n_rays: int) -> float:
    """A training step's model operations: the network forward and
    backward (3x) and the encode forward and backward (2x) over every
    sample of every pass."""
    n = n_rays * spec.samples_per_ray
    return float(n * (3 * mlp_flops_per_sample(spec)
                      + 2 * spec.n_levels * interp_flops(spec)))


def request_flops(spec: Spec, n_rays: int) -> float:
    """A test-mode render's model operations (forward only)."""
    n = n_rays * spec.samples_per_ray
    return float(n * (mlp_flops_per_sample(spec)
                      + spec.n_levels * interp_flops(spec)))
