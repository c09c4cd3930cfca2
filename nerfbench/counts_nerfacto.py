"""Operations and bytes of nerfacto's logical work (``counts.py``'s rules
for the hash grid, per field):

- a field's encode forward reads each point once (3 float32), writes each
  (point, level)'s F features once (float32), and reads each table entry
  that some (point, level) interpolates from once (F float32: the 8
  corners' rows, counted once however many points share them); its
  operations are 2 x 8 x F + 2 x 8 a (point, level);
- the networks' operations are 2 a multiply-add of each layer: the field's
  sigma net ``L F -> 64 -> 16`` and colour net ``16 + 15 + E -> 64 -> 64
  -> 3``, each proposal's ``L F -> 16 -> 1``;
- a field's encode backward into its table reads each point and each
  cotangent entry once and adds into each touched entry once: the
  forward's bytes and operations (``counts.py``'s rule for a float32
  table), for the field on every step and for the proposal fields on the
  steps that update them;
- a training step's operations: every field forward, and the backward
  (twice the network's, once the encode's) of the field on every step and
  of the proposal fields on the steps that update them.

The entries a batch touches are counted from its points with the
reference's index math (``reference/grid.py``). The least time is the
larger of the bytes over the memory bandwidth and the operations over the
float32 peak (``counts.py``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from nerfbench.counts import least_seconds
from nerfbench.reference import grid
from nerfbench.reference.nerfacto import GridSpec, Spec


def interp_flops(g: GridSpec) -> int:
    return 2 * 8 * g.n_features + 2 * 8


def mlp_flops(spec: Spec) -> List[int]:
    """Forward operations a sample of each field: the proposals', then the
    field's."""
    out = [2 * (g.n_levels * g.n_features * spec.proposal_hidden
                + spec.proposal_hidden) for g in spec.proposals]
    f, h = spec.field, spec.hidden
    macs = f.n_levels * f.n_features * h + h * (1 + spec.geo)
    macs += (16 + spec.geo + spec.embed_dim) * h + h * h + h * 3
    return out + [2 * macs]


def grids(spec: Spec) -> List[GridSpec]:
    return list(spec.proposals) + [spec.field]


def touched_count(points: torch.Tensor, g: GridSpec,
                  block: int = 1 << 18) -> int:
    """How many table entries (rows) the interpolation of ``points`` ``[N,
    3]`` reads, each counted once."""
    seen = torch.zeros(grid.entry_count(g), dtype=torch.bool,
                       device=points.device)
    for s in range(0, points.shape[0], block):
        grid.touched_entries(points[s:s + block], g, seen)
    return int(seen.sum())


def encode_work(n_points: int, touched: int, g: GridSpec) -> Dict[str, float]:
    """Bytes and operations of one field's encode forward."""
    pl = n_points * g.n_levels
    return {"bytes": float(n_points * 12 + pl * g.n_features * 4
                           + touched * g.n_features * 4),
            "flops": float(pl * interp_flops(g))}


def encode_least_seconds(points: List[torch.Tensor], spec: Spec) -> List[float]:
    """Each field's encode least time (the proposals', then the field's),
    from its points; a field's backward takes the same."""
    return [least_seconds(encode_work(p.shape[0], touched_count(p, g), g))
            for p, g in zip(points, grids(spec))]


def encode_bwd_least_seconds(least: List[float], update_share: float) -> float:
    """A step's encode backward least time from ``encode_least_seconds``:
    the field's on every step, the proposals' on the share of steps that
    update them."""
    return least[-1] + update_share * sum(least[:-1])


def step_flops(spec: Spec, samples: List[int], update_share: float) -> float:
    """A training step's model operations from the samples each field
    evaluated in it (the proposals', then the field's) and the share of
    steps that update the proposals."""
    total = 0.0
    last = len(samples) - 1
    for i, (n, g, m) in enumerate(zip(samples, grids(spec), mlp_flops(spec))):
        back = 1.0 if i == last else update_share
        total += n * (m * (1.0 + 2.0 * back)
                      + g.n_levels * interp_flops(g) * (1.0 + back))
    return total
