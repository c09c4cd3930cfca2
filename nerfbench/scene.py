"""The benchmark's scene: the Manhattan room in the Blender layout.

A frozen copy of the room generator the port's tests and smoke run use
(walls at x, y = +-1.5, floor 0, ceiling 1.5, two boxes on the floor,
scaled by 1.9 so every visible surface lies between the Blender loader's
fixed near and far, 2 and 6), with its ray tracer, its cameras and a
minimal PNG writer. The benchmark owns this copy, so a later change to the
program's scene code cannot change the data a cell trains on.

The scene is fixed: it does not depend on a run's seed. It is written once
into ``cache/`` inside this folder (``.gitignore`` lists it) and later runs
only read it; a ``done`` marker written last tells a complete scene from an
interrupted one.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cache")

ROOM_SCALE = 1.9
_ROOM_HALF = 1.5
_ROOM_ZLO, _ROOM_ZHI = 0.0, 1.5
_ROOM_BOXES = [
    ((-1.0, -1.1, 0.0), (-0.4, -0.5, 0.55), (0.75, 0.25, 0.2)),
    ((0.35, 0.3, 0.0), (1.05, 1.0, 0.35), (0.2, 0.35, 0.75)),
]
_ROOM_LIGHT = np.array([0.25, 0.15, -1.0]) / np.linalg.norm([0.25, 0.15, -1.0])
_WALL_ALBEDO = {
    (0, -1): (0.85, 0.8, 0.7), (0, 1): (0.7, 0.8, 0.85),
    (1, -1): (0.8, 0.85, 0.7), (1, 1): (0.82, 0.72, 0.82),
    (2, 1): (0.9, 0.9, 0.9),
}


def rays_np(H: int, W: int, K: np.ndarray, c2w: np.ndarray):
    """Per-pixel ray origins and directions ``[H, W, 3]`` of a pinhole
    camera (the NeRF convention: x right, y up, looking down -z)."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1],
                     -np.ones_like(i)], -1)
    rays_d = np.sum(dirs[..., None, :] * c2w[:3, :3], -1)
    return np.broadcast_to(c2w[:3, -1], rays_d.shape), rays_d


def _render_room(o: np.ndarray, rays_d: np.ndarray):
    """Ray-trace the unscaled room from inside: (rgb ``[n, 3]``, hit
    distance along the unit direction). Lambert shading from a fixed light
    plus ambient; a checkered floor; every ray hits a surface."""
    d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
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

    lo = np.array([-_ROOM_HALF, -_ROOM_HALF, _ROOM_ZLO])
    hi = np.array([_ROOM_HALF, _ROOM_HALF, _ROOM_ZHI])
    for axis in range(3):
        for sgn in (-1, 1):
            plane = lo[axis] if sgn < 0 else hi[axis]
            da = d[:, axis]
            t = np.where(np.abs(da) > 1e-9, (plane - o[:, axis])
                         / np.where(np.abs(da) > 1e-9, da, 1.0), big)
            p = o + t[:, None] * d
            inside = np.ones(n_rays, bool)
            for a2 in range(3):
                if a2 != axis:
                    inside &= (p[:, a2] >= lo[a2] - 1e-6) & (
                        p[:, a2] <= hi[a2] + 1e-6)
            n = np.zeros((n_rays, 3))
            n[:, axis] = -sgn
            if axis == 2 and sgn < 0:
                checker = (np.floor(2.0 * p[:, 0]) + np.floor(2.0 * p[:, 1])) % 2
                alb = (0.45 + 0.25 * checker)[:, None] * np.array([[1.0, 0.92, 0.8]])
            else:
                alb = np.broadcast_to(np.array(_WALL_ALBEDO[(axis, sgn)]),
                                      (n_rays, 3)).copy()
            consider(t, n, alb, inside)
    for bmin, bmax, alb in _ROOM_BOXES:
        bmin, bmax = np.asarray(bmin), np.asarray(bmax)
        safe_d = np.where(np.abs(d) > 1e-9, d, 1e-9)
        ta = (bmin[None] - o) / safe_d
        tb = (bmax[None] - o) / safe_d
        t0, t1 = np.minimum(ta, tb), np.maximum(ta, tb)
        tin, tout = t0.max(axis=-1), t1.min(axis=-1)
        hit = (tout > tin) & (tout > 1e-4)
        ax = np.argmax(t0, axis=-1)
        n = np.zeros((n_rays, 3))
        for a2 in range(3):
            sel = ax == a2
            n[sel, a2] = -np.sign(d[sel, a2])
        consider(tin, n, np.broadcast_to(np.asarray(alb), (n_rays, 3)).copy(),
                 hit)
    light = np.clip(-np.sum(best_n * _ROOM_LIGHT[None], axis=-1), 0.0, 1.0)
    rgb = np.clip(best_alb * (0.35 + 0.65 * light)[:, None], 0.0, 1.0)
    return rgb.astype(np.float32), best_t


def room_cameras(n_views: int, W: int) -> np.ndarray:
    """The training ring: ``[n_views, 4, 4]`` c2w at height 1.2 on a circle
    of radius 0.6 around the room's axis (unscaled units times the scale),
    each looking across the axis and 15 degrees down."""
    s = ROOM_SCALE
    pitch = np.radians(15.0)
    thetas = 2 * np.pi * np.arange(n_views) / n_views + 0.3
    c2ws = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    for i, th in enumerate(thetas):
        pos = np.array([-0.6 * np.cos(th), -0.6 * np.sin(th), 1.2]) * s
        c2ws[i, :3, :4] = look_pose(pos, th, pitch)
    return c2ws


def look_pose(pos: np.ndarray, yaw: float, pitch: float) -> np.ndarray:
    """``[3, 4]`` c2w at ``pos`` looking along yaw ``yaw`` and ``pitch``
    radians down, with z up."""
    fwd = np.array([np.cos(yaw), np.sin(yaw), -np.tan(pitch)])
    z = -fwd / np.linalg.norm(fwd)
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z, pos], -1).astype(np.float32)


def make_room(n_views: int, H: int, W: int, threads: int = 4) -> Dict:
    """The room seen from ``room_cameras``: ``images`` ``[N, H, W, 4]``
    (alpha 1), ``poses``, ``hwf`` and ``i_split`` (every fourth view from
    the third held out for val and test), focal 1.1 W."""
    s = ROOM_SCALE
    focal = 1.1 * W
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                 np.float32)
    c2ws = room_cameras(n_views, W)

    def render(c2w):
        ro, rd = rays_np(H, W, K, c2w[:3, :4])
        rgb, _ = _render_room(ro.reshape(-1, 3) / s, rd.reshape(-1, 3))
        return np.concatenate([rgb, np.ones_like(rgb[:, :1])], -1).reshape(H, W, 4)

    with ThreadPoolExecutor(max(1, threads)) as ex:
        images = np.stack(list(ex.map(render, c2ws)))
    idx = np.arange(n_views)
    held = idx[2::4]
    return {"images": images, "poses": c2ws, "hwf": [H, W, focal],
            "i_split": (np.setdiff1d(idx, held), held, held)}


def encode_png(img: np.ndarray) -> bytes:
    """``[H, W, C]`` uint8 (C = 3 or 4) -> PNG bytes, no filtering."""
    h, w, c = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], 1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_blender(root: str, scene: Dict) -> None:
    """``scene`` in the Blender layout: ``<split>/r_<j>.png`` and
    ``transforms_<split>.json`` with ``camera_angle_x``."""
    H, W, focal = scene["hwf"]
    angle = float(2.0 * np.arctan(0.5 * W / focal))
    for split, idxs in zip(("train", "val", "test"), scene["i_split"]):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for j, i in enumerate(idxs):
            c2w = np.eye(4)
            c2w[:3, :4] = scene["poses"][i][:3, :4]
            frames.append({"file_path": f"./{split}/r_{j}",
                           "transform_matrix": c2w.tolist()})
            img = (255 * np.clip(scene["images"][i], 0, 1)).astype(np.uint8)
            with open(os.path.join(root, split, f"r_{j}.png"), "wb") as f:
                f.write(encode_png(img))
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": angle, "frames": frames}, f)


def scene_dir(spec: Dict, cache_dir: str = CACHE_DIR) -> str:
    """The directory of the scene ``spec`` (``{"kind": "room", "n_views",
    "H", "W"}``), written on first use. Returns its path."""
    if spec.get("kind") != "room":
        raise ValueError(f"unknown scene kind {spec.get('kind')!r}")
    n, H, W = int(spec["n_views"]), int(spec["H"]), int(spec["W"])
    root = os.path.join(cache_dir, f"room_{n}x{H}x{W}")
    if not os.path.exists(os.path.join(root, "done")):
        write_blender(root, make_room(n, H, W))
        with open(os.path.join(root, "done"), "w") as f:
            f.write("ok\n")
    return root
