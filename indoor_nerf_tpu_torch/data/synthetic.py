"""Procedural multi-view scene for tests and benchmarks.

A copy of indoor_nerf_tpu/data/synthetic.py, which cannot be imported
without jax (its package imports jax); tests hold the copy identical.

The reference relies on the Blender synthetic download for any runnable
example; this module generates an analytic stand-in — a normal-colored,
checker-modulated sphere on a white background, viewed from cameras on an
orbit — so end-to-end convergence tests and throughput benchmarks run with
zero external data. Geometry conventions (camera orbit radius 4, near/far
2/6, NeRF-style c2w with camera -z toward the origin) match the Blender
loader's (reference: PocketNeRF/load_blender.py:30-35, run_nerf.py:768-769).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from indoor_nerf_tpu_torch.ops.rays import get_rays_np


def _look_at_pose(position: np.ndarray) -> np.ndarray:
    """NeRF-convention c2w [3,4]: camera -z points at the origin."""
    z = position / np.linalg.norm(position)
    up = np.array([0.0, 0.0, 1.0])
    x = np.cross(up, z)
    if np.linalg.norm(x) < 1e-6:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, position], axis=-1).astype(np.float32)


def _render_analytic(rays_o: np.ndarray, rays_d: np.ndarray) -> np.ndarray:
    """Ray-trace a unit sphere at the origin with a checker-normal albedo."""
    d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    o = rays_o
    b = np.sum(o * d, axis=-1)
    c = np.sum(o * o, axis=-1) - 1.0
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t > 0
    p = o + t[..., None] * d
    n = p  # unit sphere: normal == position
    checker = ((np.floor(2.5 * p[..., 0]) + np.floor(2.5 * p[..., 1])
                + np.floor(2.5 * p[..., 2])) % 2).astype(np.float32)
    albedo = 0.5 + 0.5 * n
    albedo = albedo * (0.6 + 0.4 * checker[..., None])
    light = np.clip(np.sum(n * np.array([0.0, 0.0, 1.0]), axis=-1), 0.2, 1.0)
    rgb = albedo * light[..., None]
    out = np.ones_like(rgb)  # white background
    out[hit] = np.clip(rgb[hit], 0.0, 1.0)
    return out.astype(np.float32)


def make_synthetic_scene(
    n_views: int = 12, H: int = 64, W: int = 64, seed: int = 0,
    radius: float = 4.0,
) -> Dict[str, np.ndarray]:
    """Build a small multi-view-consistent scene.

    Returns a dict with images [N,H,W,3], poses [N,3,4], hwf, K, near, far,
    bbox (min, max), and i_split (train/val/test index arrays).
    """
    rng = np.random.default_rng(seed)
    focal = 0.9 * W
    K = np.array(
        [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32
    )

    thetas = np.linspace(0, 2 * np.pi, n_views, endpoint=False)
    phis = rng.uniform(-0.9, -0.2, size=n_views)  # above the equator
    poses, images = [], []
    for theta, phi in zip(thetas, phis):
        pos = radius * np.array(
            [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), -np.sin(phi)]
        )
        c2w = _look_at_pose(pos)
        rays_o, rays_d = get_rays_np(H, W, K, c2w)
        images.append(_render_analytic(rays_o.reshape(-1, 3),
                                       rays_d.reshape(-1, 3)).reshape(H, W, 3))
        poses.append(c2w)

    n_train = max(1, int(0.8 * n_views))
    idx = np.arange(n_views)
    return {
        "images": np.stack(images),
        "poses": np.stack(poses),
        "hwf": [H, W, focal],
        "K": K,
        "near": 2.0,
        "far": 6.0,
        "bbox_min": (-1.5, -1.5, -1.5),
        "bbox_max": (1.5, 1.5, 1.5),
        "i_split": (idx[:n_train], idx[n_train:], idx[n_train:]),
    }


# ---------------------------------------------------------------------------
# Procedural indoor room — the structural-priors test scene.
# ---------------------------------------------------------------------------

_ROOM_HALF = 1.5       # walls at x,y = +-1.5
_ROOM_ZLO, _ROOM_ZHI = 0.0, 1.5
_ROOM_BOXES = [        # (min3, max3, albedo) — furniture on the floor
    ((-1.0, -1.1, 0.0), (-0.4, -0.5, 0.55), (0.75, 0.25, 0.2)),
    ((0.35, 0.3, 0.0), (1.05, 1.0, 0.35), (0.2, 0.35, 0.75)),
]
_ROOM_LIGHT = np.array([0.25, 0.15, -1.0]) / np.linalg.norm(
    [0.25, 0.15, -1.0])


def _render_room(rays_o: np.ndarray, rays_d: np.ndarray,
                 with_t: bool = False):
    """Ray-trace the analytic room: floor/ceiling/4 walls seen from inside
    plus two axis-aligned boxes. Lambert shading from a fixed light +
    ambient; floor is checkered (gives the planarity losses texture to
    work against). Every ray hits geometry (indoor scene — no background).
    With ``with_t`` also returns each ray's hit distance along its unit
    direction."""
    d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    o = rays_o
    n_rays = o.shape[0]
    big = 1e9

    best_t = np.full(n_rays, big)
    best_n = np.zeros((n_rays, 3))
    best_alb = np.zeros((n_rays, 3))

    def consider(t, n, alb, valid):
        nonlocal best_t, best_n, best_alb
        upd = valid & (t > 1e-4) & (t < best_t)
        best_t = np.where(upd, t, best_t)
        best_n = np.where(upd[:, None], n, best_n)
        best_alb = np.where(upd[:, None], alb, best_alb)

    # Room interior: exit of the slab box (the nearest surface looking out).
    lo = np.array([-_ROOM_HALF, -_ROOM_HALF, _ROOM_ZLO])
    hi = np.array([_ROOM_HALF, _ROOM_HALF, _ROOM_ZHI])
    wall_albedo = {
        (0, -1): (0.85, 0.8, 0.7), (0, 1): (0.7, 0.8, 0.85),
        (1, -1): (0.8, 0.85, 0.7), (1, 1): (0.82, 0.72, 0.82),
        (2, -1): None,  # floor handled separately (checker)
        (2, 1): (0.9, 0.9, 0.9),  # ceiling
    }
    for axis in range(3):
        for sgn in (-1, 1):
            plane = lo[axis] if sgn < 0 else hi[axis]
            da = d[:, axis]
            t = np.where(np.abs(da) > 1e-9, (plane - o[:, axis])
                         / np.where(np.abs(da) > 1e-9, da, 1.0), big)
            p = o + t[:, None] * d
            inside = np.ones(n_rays, bool)
            for a2 in range(3):
                if a2 == axis:
                    continue
                inside &= (p[:, a2] >= lo[a2] - 1e-6) & (
                    p[:, a2] <= hi[a2] + 1e-6)
            n = np.zeros((n_rays, 3))
            n[:, axis] = -sgn  # interior-facing normal
            if axis == 2 and sgn < 0:  # floor checker
                checker = ((np.floor(2.0 * p[:, 0])
                            + np.floor(2.0 * p[:, 1])) % 2)
                alb = (0.45 + 0.25 * checker)[:, None] * np.array(
                    [[1.0, 0.92, 0.8]])
            else:
                alb = np.broadcast_to(
                    np.array(wall_albedo[(axis, sgn)]), (n_rays, 3)).copy()
            consider(t, n, alb, inside)

    # Boxes (seen from outside: slab entry).
    for bmin, bmax, alb in _ROOM_BOXES:
        bmin = np.asarray(bmin)
        bmax = np.asarray(bmax)
        safe_d = np.where(np.abs(d) > 1e-9, d, 1e-9)
        ta = (bmin[None] - o) / safe_d
        tb = (bmax[None] - o) / safe_d
        t0 = np.minimum(ta, tb)
        t1 = np.maximum(ta, tb)
        tin = t0.max(axis=-1)
        tout = t1.min(axis=-1)
        hit = (tout > tin) & (tout > 1e-4)
        ax = np.argmax(t0, axis=-1)
        p = o + tin[:, None] * d
        n = np.zeros((n_rays, 3))
        for a2 in range(3):
            sel = ax == a2
            n[sel, a2] = -np.sign(d[sel, a2])
        consider(tin, n, np.broadcast_to(np.asarray(alb),
                                         (n_rays, 3)).copy(), hit)

    light = np.clip(-np.sum(best_n * _ROOM_LIGHT[None], axis=-1), 0.0, 1.0)
    rgb = np.clip(best_alb * (0.35 + 0.65 * light)[:, None], 0.0, 1.0
                  ).astype(np.float32)
    return (rgb, best_t) if with_t else rgb


def jitter_exposure(images: np.ndarray, jittered: np.ndarray,
                    exposure_jitter: float, rng: np.random.Generator
                    ) -> np.ndarray:
    """Per-view exposure gains: the RGB of each view ``jittered`` of
    ``images`` ``[N, H, W, C]`` scaled in place by a gain drawn from
    U(1 - j, 1 + j) with ``rng`` and clipped to [0, 1] (nothing is drawn
    at ``exposure_jitter`` 0). Returns the ``[N]`` gains, 1 on the other
    views."""
    gains = np.ones(len(images), np.float32)
    if exposure_jitter > 0.0:
        gains[jittered] = rng.uniform(
            1.0 - exposure_jitter, 1.0 + exposure_jitter, size=len(jittered)
        ).astype(np.float32)
        images[..., :3] = np.clip(
            images[..., :3] * gains[:, None, None, None], 0.0, 1.0)
    return gains


def make_room_scene(
    n_views: int = 12, H: int = 64, W: int = 64, seed: int = 0,
    n_train: Optional[int] = None, exposure_jitter: float = 0.0,
    jitter_test: bool = False,
) -> Dict[str, np.ndarray]:
    """Procedural INDOOR scene: a Manhattan-world room (checker floor, 4
    walls, ceiling, two boxes) viewed from cameras inside it.

    This is the structural-priors test scene — the reference's headline
    few-shot indoor setting (README.md:43, test_structural_v2.sh) without
    external data: dominant axis-aligned planes for the Manhattan/
    planarity losses, and an ``n_train`` override for few-shot splits
    (reference protocol: 8 train views, notebook cell 6).

    ``exposure_jitter=j > 0`` scales each TRAIN image by a per-view gain
    drawn from U(1-j, 1+j) (zero-mean in gain, clipped to [0, 1]) while
    held-out views stay clean — the per-capture auto-exposure residual of
    real phone footage that the reference's EV normalization (iPhone
    notebook cell 5) only partially removes, and the failure mode the
    per-image appearance latents (FieldConfig.n_appearance) target.

    ``jitter_test=True`` additionally jitters the HELD-OUT views with
    their own independent gains (the real-capture case: a test photo's
    exposure is unknown too). Scoring such views fairly requires the
    NeRF-W half-image protocol (render/appearance.py): fit a latent on
    the left half, score the right half. The per-view gains are returned
    under ``"exposure_gains"`` for diagnostics.
    """
    rng = np.random.default_rng(seed)
    focal = 0.7 * W  # wide-ish lens, indoor
    K = np.array(
        [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32
    )
    thetas = np.linspace(0, 2 * np.pi, n_views, endpoint=False)
    poses, images = [], []
    for theta in thetas:
        pos = np.array([0.45 * np.cos(theta), 0.45 * np.sin(theta),
                        0.75 + 0.1 * rng.uniform(-1, 1)])
        # Look outward at the walls, slightly downward (floor visible).
        target = np.array([1.3 * np.cos(theta), 1.3 * np.sin(theta), 0.3])
        z = pos - target  # NeRF convention: camera -z toward target
        z = z / np.linalg.norm(z)
        up = np.array([0.0, 0.0, 1.0])
        x = np.cross(up, z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.stack([x, y, z, pos], axis=-1).astype(np.float32)
        rays_o, rays_d = get_rays_np(H, W, K, c2w)
        images.append(_render_room(rays_o.reshape(-1, 3),
                                   rays_d.reshape(-1, 3)).reshape(H, W, 3))
        poses.append(c2w)

    if n_train is None:
        n_train = max(1, int(0.8 * n_views))
    idx = np.arange(n_views)
    images = np.stack(images)
    gains = jitter_exposure(
        images, np.arange(n_views if jitter_test else n_train),
        exposure_jitter, rng)
    return {
        "exposure_gains": gains,
        "images": images,
        "poses": np.stack(poses),
        "hwf": [H, W, focal],
        "K": K,
        "near": 0.1,
        "far": 6.0,
        "bbox_min": (-1.7, -1.7, -0.2),
        "bbox_max": (1.7, 1.7, 1.7),
        "i_split": (idx[:n_train], idx[n_train:], idx[n_train:]),
    }
