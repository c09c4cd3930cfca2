"""Shared camera-pose helpers (host-side numpy).

``pose_spherical`` and its helpers, copied from indoor_nerf_tpu/data/poses.py
(whose package imports jax); tests hold the copy identical."""

from __future__ import annotations

import numpy as np


def trans_t(t: float) -> np.ndarray:
    return np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]], np.float32
    )


def rot_phi(phi: float) -> np.ndarray:
    return np.array(
        [
            [1, 0, 0, 0],
            [0, np.cos(phi), -np.sin(phi), 0],
            [0, np.sin(phi), np.cos(phi), 0],
            [0, 0, 0, 1],
        ],
        np.float32,
    )


def rot_theta(th: float) -> np.ndarray:
    return np.array(
        [
            [np.cos(th), 0, -np.sin(th), 0],
            [0, 1, 0, 0],
            [np.sin(th), 0, np.cos(th), 0],
            [0, 0, 0, 1],
        ],
        np.float32,
    )


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Spherical orbit camera pose (reference: load_blender.py:30-35)."""
    c2w = trans_t(radius)
    c2w = rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = (
        np.array(
            [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32
        )
        @ c2w
    )
    return c2w

