"""Scenes written to disk in the layouts the file loaders read.

Nothing of a real capture is in the repository, so the loaders' tests and
the card's smoke run make their scenes here, from the port's own analytic
scenes, and write them with ``utils/png.py``:

- ``make_sphere_scene`` + ``write_blender_scene``: the checker sphere of
  ``data/synthetic.py`` (orbit radius 4, near/far 2/6) in the Blender
  layout, ``transforms_{train,val,test}.json`` and RGBA PNGs whose
  background is transparent (so ``--white_bkgd`` composites it);
- ``make_plane_scene`` + ``write_llff_scene``: a forward-facing rig of
  cameras on a small circle looking down -z at a smooth-textured plane, in
  the LLFF layout, ``poses_bounds.npy``, ``images/`` and
  ``images_{factor}/``;
- ``make_room_blender_scene`` + ``write_blender_scene``: the Manhattan
  room of ``data/synthetic.py::make_room_scene`` (the structural priors'
  scene) scaled to the Blender loader's fixed near/far, for the
  ``configs/norcliffe_common_room*.txt`` files, which say ``dataset_type =
  blender``.

Views are rendered in a thread pool (numpy releases the GIL in its array
passes), so an 800x800 scene of a few dozen views takes seconds.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

import numpy as np

from indoor_nerf_tpu_torch.data.synthetic import (
    _render_analytic,
    _render_room,
    jitter_exposure,
    make_synthetic_scene,
)
from indoor_nerf_tpu_torch.ops.rays import get_rays_np
from indoor_nerf_tpu_torch.utils.png import encode_png, to8b

PLANE_Z = -4.0  # the textured plane of make_plane_scene


def _pinhole(H: int, W: int, focal: float) -> np.ndarray:
    return np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                    np.float32)


def _parallel(fn, items, threads: int):
    with ThreadPoolExecutor(max(1, threads)) as ex:
        return list(ex.map(fn, items))


def _write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def make_sphere_scene(n_views: int, H: int, W: int, threads: int = 8) -> Dict:
    """``data/synthetic.py::make_synthetic_scene``'s cameras and sphere at
    H x W, with an alpha channel: ``images`` ``[N, H, W, 4]`` float32 (rgb 0
    and alpha 0 off the sphere), ``poses`` ``[N, 4, 4]``, ``hwf``. Every
    other view is held out: train the even views, val and test the odd."""
    poses = make_synthetic_scene(n_views=n_views, H=1, W=1)["poses"]
    focal = 0.9 * W
    K = _pinhole(H, W, focal)

    def render(c2w):
        ro, rd = get_rays_np(H, W, K, c2w)
        rgb = _render_analytic(ro.reshape(-1, 3), rd.reshape(-1, 3))
        rgb = rgb.reshape(H, W, 3)
        hit = ~np.all(rgb == 1.0, axis=-1, keepdims=True)  # white = missed
        return np.concatenate([rgb * hit, hit], -1).astype(np.float32)

    c2ws = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    c2ws[:, :3, :4] = poses
    idx = np.arange(n_views)
    return {"images": np.stack(_parallel(render, poses, threads)),
            "poses": c2ws, "hwf": [H, W, focal],
            "i_split": (idx[0::2], idx[1::2], idx[1::2])}


def write_blender_scene(root: str, scene: Dict, threads: int = 8) -> None:
    """``scene`` (``images`` ``[N, H, W, 3 or 4]`` in [0, 1], ``poses``
    ``[N, 3 or 4, 4]`` NeRF c2w, ``hwf``, ``i_split``) in the Blender
    layout under ``root``: ``<split>/r_<j>.png`` and
    ``transforms_<split>.json`` with ``camera_angle_x``."""
    H, W, focal = scene["hwf"]
    camera_angle_x = float(2.0 * np.arctan(0.5 * W / focal))
    jobs = []
    for split, idxs in zip(("train", "val", "test"), scene["i_split"]):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for j, i in enumerate(idxs):
            c2w = np.eye(4)
            c2w[:3, :4] = scene["poses"][i][:3, :4]
            frames.append({"file_path": f"./{split}/r_{j}",
                           "transform_matrix": c2w.tolist()})
            jobs.append((os.path.join(root, split, f"r_{j}.png"), i))
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)
    _parallel(lambda job: _write_png(job[0], to8b(scene["images"][job[1]])),
              jobs, threads)


def _plane_color(px: np.ndarray, py: np.ndarray) -> np.ndarray:
    """A smooth three-channel texture of the plane (band-limited, so a small
    field fits it quickly)."""
    r = 0.5 + 0.45 * np.sin(1.7 * px)
    g = 0.5 + 0.45 * np.sin(1.3 * py + 0.7)
    b = 0.5 + 0.45 * np.sin(1.1 * (px + py))
    return np.stack([r, g, b], axis=-1)


def _plane_view(c2w: np.ndarray, H: int, W: int, focal: float) -> np.ndarray:
    rays_o, rays_d = get_rays_np(H, W, _pinhole(H, W, focal), c2w)
    t = (PLANE_Z - rays_o[..., 2]) / rays_d[..., 2]
    p = rays_o + t[..., None] * rays_d
    return _plane_color(p[..., 0], p[..., 1]).astype(np.float32)


def make_plane_scene(n_views: int, radius: float = 0.25) -> np.ndarray:
    """The forward-facing rig: ``[N, 3, 4]`` NeRF c2w, cameras on a circle
    of ``radius`` around the origin in the z = 0 plane, looking down -z at
    the plane z = PLANE_Z."""
    ang = 2 * np.pi * np.arange(n_views) / n_views
    c2ws = np.zeros((n_views, 3, 4), np.float32)
    c2ws[:, :, :3] = np.eye(3)
    c2ws[:, 0, 3] = radius * np.cos(ang)
    c2ws[:, 1, 3] = radius * np.sin(ang)
    return c2ws


def write_llff_scene(root: str, c2ws: np.ndarray, H: int, W: int,
                     focal: float, factor: int,
                     bounds: Sequence[float] = (3.2, 5.0),
                     threads: int = 8) -> np.ndarray:
    """The plane seen from ``c2ws`` in the LLFF layout under ``root``:
    ``poses_bounds.npy`` (LLFF's [down, right, back] columns, the full-size
    ``[H, W, focal]`` column, ``bounds``), ``images_{factor}/`` rendered at
    ``H / factor`` x ``W / factor`` with ``focal / factor`` (what the
    loader trains on) and ``images/`` at H x W (the full-size captures; as
    the loader reads only the first one's shape, they are the small views
    repeated ``factor`` x ``factor``). Returns the small views."""
    n = len(c2ws)
    h, w = H // factor, W // factor
    small = np.stack(_parallel(lambda c: _plane_view(c, h, w, focal / factor),
                               c2ws, threads))
    for d in ("images", f"images_{factor}"):
        os.makedirs(os.path.join(root, d), exist_ok=True)

    def write(i):
        img = to8b(small[i])
        _write_png(os.path.join(root, f"images_{factor}", f"img_{i:03d}.png"),
                   img)
        _write_png(os.path.join(root, "images", f"img_{i:03d}.png"),
                   np.repeat(np.repeat(img, factor, 0), factor, 1))

    _parallel(write, range(n), threads)
    poses = np.zeros((n, 3, 5), np.float64)
    # The inverse of the loader's axis fix (data/llff.py::load_llff_data).
    poses[:, :, 0] = -c2ws[:, :, 1]
    poses[:, :, 1] = c2ws[:, :, 0]
    poses[:, :, 2] = c2ws[:, :, 2]
    poses[:, :, 3] = c2ws[:, :, 3]
    poses[:, :, 4] = [H, W, focal]
    bds = np.tile(np.asarray(bounds, np.float64), (n, 1))
    np.save(os.path.join(root, "poses_bounds.npy"),
            np.concatenate([poses.reshape(n, -1), bds], -1))
    return small


# The room's scale in blender layout: the Blender loader fixes near/far at
# 2/6 (data/load.py), and at this scale and with the cameras of
# make_room_blender_scene every surface a camera sees lies at a camera
# depth between 2.24 and 5.56 (tests/test_torch_loaders.py holds it in
# [2, 6]).
ROOM_SCALE = 1.9


def make_room_blender_scene(n_views: int, H: int, W: int,
                            threads: int = 8, exposure_jitter: float = 0.0,
                            jitter_test: bool = False) -> Dict:
    """The Manhattan room (walls at x, y = +-1.5, floor 0, ceiling 1.5, two
    boxes on the floor; ``data/synthetic.py``) scaled by ``ROOM_SCALE``
    (walls at +-2.85, ceiling 2.85), seen from ``n_views`` cameras at
    height 2.28 on a circle of radius 1.14 around the room's axis, each looking
    across the axis toward the opposite walls and 15 degrees down (floor,
    walls and boxes in view), with focal 1.1 W. A scaled room seen from
    scaled positions is the room seen from the positions unscaled, so the
    views are ``_render_room``'s. Returns ``images`` ``[N, H, W, 4]`` (alpha
    1: every ray hits a surface), ``poses`` ``[N, 4, 4]``, ``hwf``,
    ``depth`` ``[N, H, W]`` (each pixel's depth along the camera axis, in
    the scaled room: the loader's ``z_vals``) and ``i_split``: every fourth
    view, starting at the third, held out for val and test. With
    ``exposure_jitter`` j > 0 the training views (with ``jitter_test``
    every view) carry exposure gains from U(1 - j, 1 + j) drawn from seed 0
    (``jitter_exposure``); ``exposure_gains`` holds each view's."""
    s = ROOM_SCALE
    focal = 1.1 * W
    K = _pinhole(H, W, focal)
    pitch = np.radians(15.0)
    thetas = 2 * np.pi * np.arange(n_views) / n_views + 0.3
    c2ws = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    for i, th in enumerate(thetas):
        pos = np.array([-0.6 * np.cos(th), -0.6 * np.sin(th), 1.2]) * s
        fwd = np.array([np.cos(th), np.sin(th), -np.tan(pitch)])
        z = -fwd / np.linalg.norm(fwd)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        c2ws[i, :3, :4] = np.stack([x, np.cross(z, x), z, pos], -1)

    def render(c2w):
        ro, rd = get_rays_np(H, W, K, c2w[:3, :4])
        rd = rd.reshape(-1, 3)
        rgb, t = _render_room(ro.reshape(-1, 3) / s, rd, with_t=True)
        depth = s * t / np.linalg.norm(rd, axis=-1)
        return (np.concatenate([rgb, np.ones_like(rgb[:, :1])], -1
                               ).reshape(H, W, 4),
                depth.reshape(H, W).astype(np.float32))

    views = _parallel(render, c2ws, threads)
    idx = np.arange(n_views)
    held = idx[2::4]
    train = np.setdiff1d(idx, held)
    images = np.stack([v[0] for v in views])
    gains = jitter_exposure(images, idx if jitter_test else train,
                            exposure_jitter, np.random.default_rng(0))
    return {"images": images,
            "depth": np.stack([v[1] for v in views]),
            "poses": c2ws, "hwf": [H, W, focal],
            "i_split": (train, held, held), "exposure_gains": gains}
