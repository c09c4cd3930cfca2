"""Encodings of the serving path: grid level resolutions and SH view features.

Ports of ``indoor_nerf_tpu/ops/encoding.py::level_resolutions`` (a
numpy-only copy; the JAX module imports jax) and ``sh_encode``.
"""

from __future__ import annotations

import numpy as np
import torch


def level_resolutions(config) -> np.ndarray:
    """Per-level grid resolutions, float32 ``[L]``.

    ``config`` is any object with ``n_levels``, ``base_resolution`` and
    ``finest_resolution``. res_l = floor(base * b^l) with geometric growth
    b = exp((ln finest - ln base) / (L - 1)), in float32 like the reference.
    """
    base = np.float32(config.base_resolution)
    finest = np.float32(config.finest_resolution)
    if config.n_levels > 1:
        b = np.exp(
            (np.log(finest) - np.log(base)) / np.float32(config.n_levels - 1)
        ).astype(np.float32)
    else:
        b = np.float32(1.0)
    levels = np.arange(config.n_levels, dtype=np.float32)
    return np.floor(base * b**levels).astype(np.float32)


# Real SH coefficients (ops/encoding.py:178-187).
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def sh_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real spherical harmonics of unit directions ``[..., 3]`` -> ``[..., degree**2]``."""
    if not 1 <= degree <= 5:
        raise ValueError(f"degree must be in [1, 5], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    comps = [torch.full_like(x, _C0)]
    if degree > 1:
        comps += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        comps += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree > 3:
        comps += [
            _C3[0] * y * (3 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4 * zz - xx - yy),
            _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            _C3[4] * x * (4 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3 * yy),
        ]
    if degree > 4:
        comps += [
            _C4[0] * xy * (xx - yy),
            _C4[1] * yz * (3 * xx - yy),
            _C4[2] * xy * (7 * zz - 1),
            _C4[3] * yz * (7 * zz - 3),
            _C4[4] * (zz * (35 * zz - 30) + 3),
            _C4[5] * xz * (7 * zz - 3),
            _C4[6] * (xx - yy) * (7 * zz - 1),
            _C4[7] * xz * (xx - 3 * yy),
            _C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(comps, dim=-1)
