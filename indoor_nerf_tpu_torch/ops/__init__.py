"""Tensor ops of the port; the CUDA kernel wrappers live here.

``lane_select`` is the one public op of the JAX package's
``ops/pallas/__init__.py``; no path of either package calls it."""

from indoor_nerf_tpu_torch.ops.lane_gather import lane_select

__all__ = ["lane_select"]
