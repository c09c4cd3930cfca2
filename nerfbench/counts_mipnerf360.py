"""Operations of Mip-NeRF 360's two MLPs (``reference/mipnerf360.py``'s
widths), the FLOPs its benchmark metrics divide:

- a net's forward operations a sample are 2 a multiply-add of each layer
  (``layer_shapes``: its trunk, the IPE read again after the 5th layer,
  the density head, and for the NeRF MLP the bottleneck, the view layer
  and rgb), biases and activations not counted;
- a training step's model operations: every level's forward and its
  backward, twice the forward (the inputs' and the weights' gradients),
  for the proposal MLP at both proposal levels and the NeRF MLP at the
  field level: 3 x the forward a sample, times the samples each level
  evaluated (the program's counters ``proposal_0``, ``proposal_1``,
  ``field``).

The elementwise work (the Gaussians, the IPE, compositing, the
resampling) is not counted: it is memory- and latency-bound, and the
GEMMs are 99.9% of the arithmetic.
"""

from __future__ import annotations

from typing import List, Sequence

from nerfbench.reference.mipnerf360 import Spec, layer_shapes


def mlp_flops(spec: Spec) -> List[int]:
    """Forward operations a sample: ``[proposal MLP, NeRF MLP]``."""
    out = {"proposal_mlp": 0, "nerf_mlp": 0}
    for name, (a, b) in layer_shapes(spec):
        out[name.split(".")[0]] += 2 * a * b
    return [out["proposal_mlp"], out["nerf_mlp"]]


def level_flops(spec: Spec) -> List[int]:
    """Forward operations a sample at each level: both proposal levels
    run the proposal MLP, the field level the NeRF MLP."""
    prop, nerf = mlp_flops(spec)
    return [prop] * len(spec.proposal_samples) + [nerf]


def forward_flops(spec: Spec, samples: Sequence[float]) -> float:
    """The nets' forward operations a step, at ``samples`` a step per
    level."""
    return float(sum(f * n for f, n in zip(level_flops(spec), samples)))


def step_flops(spec: Spec, samples: Sequence[float]) -> float:
    """A training step's model operations: forward and backward."""
    return 3.0 * forward_flops(spec, samples)
