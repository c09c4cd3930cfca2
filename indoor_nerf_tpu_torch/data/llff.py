"""LLFF forward-facing dataset loader, copied from indoor_nerf_tpu/data/
llff.py (reference: PocketNeRF/load_llff.py).

poses_bounds.npy parsing, on-disk minification (cv2 INTER_AREA, only where
``images_{factor}/`` is missing; cv2 and imageio are imported there and
named when absent), pose recentering, spherification, spiral render path,
bd rescaling, auto-holdout. Images are read through ``data/images.py``
(``.png`` with the port's reader).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from indoor_nerf_tpu_torch.data.bbox import get_bbox3d_for_llff
from indoor_nerf_tpu_torch.data.images import imread, require

_IMG_EXTS = ("JPG", "jpg", "png", "jpeg", "PNG")


def _minify(basedir: str, factors=(), resolutions=()):
    """Create images_{r}/ downsampled copies if missing
    (reference: load_llff.py:9-58). Uses cv2 instead of ImageMagick."""
    need = False
    for r in factors:
        if not os.path.exists(os.path.join(basedir, f"images_{r}")):
            need = True
    for r in resolutions:
        if not os.path.exists(os.path.join(basedir, f"images_{r[1]}x{r[0]}")):
            need = True
    if not need:
        return

    what = f"making {basedir}'s missing images_* directories"
    cv2 = require("cv2", what)
    imageio = require("imageio.v2", what)

    imgdir = os.path.join(basedir, "images")
    files = [
        os.path.join(imgdir, f)
        for f in sorted(os.listdir(imgdir))
        if f.endswith(_IMG_EXTS)
    ]
    for r in list(factors) + list(resolutions):
        if isinstance(r, int):
            name = f"images_{r}"
        else:
            name = f"images_{r[1]}x{r[0]}"
        outdir = os.path.join(basedir, name)
        if os.path.exists(outdir):
            continue
        print("Minifying", r, basedir)
        os.makedirs(outdir)
        for f in files:
            img = imageio.imread(f)
            if isinstance(r, int):
                new_w = int(round(img.shape[1] / r))
                new_h = int(round(img.shape[0] / r))
            else:
                new_h, new_w = r
            small = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_AREA)
            base = os.path.splitext(os.path.basename(f))[0]
            imageio.imwrite(os.path.join(outdir, base + ".png"), small)


def _load_data(basedir: str, factor=None, width=None, height=None,
               load_imgs=True):
    """(reference: load_llff.py:63-119)"""
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    img0 = [
        os.path.join(basedir, "images", f)
        for f in sorted(os.listdir(os.path.join(basedir, "images")))
        if f.endswith(("JPG", "jpg", "png"))
    ][0]
    sh = imread(img0).shape

    sfx = ""
    if factor is not None:
        sfx = f"_{factor}"
        _minify(basedir, factors=[factor])
    elif height is not None:
        factor = sh[0] / float(height)
        width = int(sh[1] / factor)
        _minify(basedir, resolutions=[[height, width]])
        sfx = f"_{width}x{height}"
    elif width is not None:
        factor = sh[1] / float(width)
        height = int(sh[0] / factor)
        _minify(basedir, resolutions=[[height, width]])
        sfx = f"_{width}x{height}"
    else:
        factor = 1

    imgdir = os.path.join(basedir, "images" + sfx)
    if not os.path.exists(imgdir):
        raise FileNotFoundError(f"{imgdir} does not exist")

    imgfiles = [
        os.path.join(imgdir, f)
        for f in sorted(os.listdir(imgdir))
        if f.endswith(("JPG", "jpg", "png"))
    ]
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(
            f"Mismatch between imgs {len(imgfiles)} and poses {poses.shape[-1]}"
        )

    sh = imread(imgfiles[0]).shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor

    if not load_imgs:
        return poses, bds

    imgs = [imread(f)[..., :3] / 255.0 for f in imgfiles]
    imgs = np.stack(imgs, -1)
    return poses, bds, imgs


def normalize(x):
    return x / np.linalg.norm(x)


def viewmatrix(z, up, pos):
    """(reference: load_llff.py:129-135)"""
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses):
    """(reference: load_llff.py:141-150)"""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], 1)


def render_path_spiral(c2w, up, rads, focal, zdelta, zrate, rots, N):
    """Spiral eval path (reference: load_llff.py:154-163)."""
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = np.dot(
            c2w[:3, :4],
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
            * rads,
        )
        z = normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(np.concatenate([viewmatrix(z, up, c), hwf], 1))
    return render_poses


def recenter_poses(poses):
    """(reference: load_llff.py:167-179)"""
    poses_ = poses + 0
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    poses_h = np.concatenate([poses[:, :3, :4], bottom], -2)
    poses_h = np.linalg.inv(c2w) @ poses_h
    poses_[:, :3, :4] = poses_h[:, :3, :4]
    return poses_


def spherify_poses(poses, bds):
    """(reference: load_llff.py:185-241)"""
    p34_to_44 = lambda p: np.concatenate(
        [p, np.tile(np.reshape(np.eye(4)[-1, :], [1, 1, 4]), [p.shape[0], 1, 1])], 1
    )
    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    def min_line_dist(rays_o, rays_d):
        a_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
        b_i = -a_i @ rays_o
        return np.squeeze(
            -np.linalg.inv((np.transpose(a_i, [0, 2, 1]) @ a_i).mean(0))
            @ (b_i).mean(0)
        )

    center = min_line_dist(rays_o, rays_d)
    up = (poses[:, :3, 3] - center).mean(0)

    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))

    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad**2 - zh**2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = normalize(camorigin)
        vec0 = normalize(np.cross(vec2, up))
        vec1 = normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], 1))

    new_poses = np.stack(new_poses, 0)
    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)],
        -1,
    )
    poses_reset = np.concatenate(
        [
            poses_reset[:, :3, :4],
            np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape),
        ],
        -1,
    )
    return poses_reset, new_poses, bds


def load_llff_data(
    basedir: str,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: float = 0.75,
    spherify: bool = False,
    path_zflat: bool = False,
) -> Tuple:
    """(reference: load_llff.py:244-319). Returns
    (images, poses(+hwf col), bds, render_poses, i_test, bounding_box)."""
    poses, bds, imgs = _load_data(basedir, factor=factor)
    print("Loaded", basedir, bds.min(), bds.max())

    # LLFF [down right back] -> NeRF [right up back] axis fix.
    poses = np.concatenate(
        [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1
    )
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    images = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = poses_avg(poses)
        up = normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)

        zdelta = close_depth * 0.2
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        c2w_path = c2w
        n_views, n_rots = 120, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            n_rots = 1
            n_views //= 2
        render_poses = render_path_spiral(
            c2w_path, up, rads, focal, zdelta, zrate=0.5, rots=n_rots, N=n_views
        )

    render_poses = np.array(render_poses).astype(np.float32)

    c2w = poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))
    print("HOLDOUT view is", i_test)

    bounding_box = get_bbox3d_for_llff(
        poses[:, :3, :4], poses[0, :3, -1], near=0.0, far=1.0
    )
    return images, poses, bds, render_poses, i_test, bounding_box
