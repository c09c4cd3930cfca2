"""DeepVoxels dataset loader, copied from indoor_nerf_tpu/data/deepvoxels.py
(reference: PocketNeRF/load_deepvoxels.py); images through ``data/images.py``."""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from indoor_nerf_tpu_torch.data.images import imread


def _parse_intrinsics(filepath: str, trgt_sidelength: int, invert_y: bool = False):
    """(reference: load_deepvoxels.py:9-46)"""
    with open(filepath) as file:
        f, cx, cy = list(map(float, file.readline().split()))[:3]
        grid_barycenter = np.array(list(map(float, file.readline().split())))
        near_plane = float(file.readline())
        scale = float(file.readline())
        height, width = map(float, file.readline().split())
        try:
            world2cam_poses = int(file.readline())
        except ValueError:
            world2cam_poses = None
    world2cam_poses = bool(world2cam_poses) if world2cam_poses is not None else False

    cx = cx / width * trgt_sidelength
    cy = cy / height * trgt_sidelength
    f = trgt_sidelength / height * f
    fy = -f if invert_y else f
    full_intrinsic = np.array(
        [[f, 0.0, cx, 0.0], [0.0, fy, cy, 0], [0.0, 0, 1, 0], [0, 0, 0, 1]]
    )
    return full_intrinsic, grid_barycenter, scale, near_plane, world2cam_poses


def _load_pose(filename: str) -> np.ndarray:
    nums = open(filename).read().split()
    return np.array([float(x) for x in nums]).reshape([4, 4]).astype(np.float32)


def _dir2poses(posedir: str) -> np.ndarray:
    """(reference: load_deepvoxels.py:65-75)"""
    poses = np.stack(
        [
            _load_pose(os.path.join(posedir, f))
            for f in sorted(os.listdir(posedir))
            if f.endswith("txt")
        ],
        0,
    )
    transf = np.array(
        [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1.0]]
    )
    poses = poses @ transf
    return poses[:, :3, :4].astype(np.float32)


def load_dv_data(scene="cube", basedir="/data/deepvoxels", testskip=8) -> Tuple:
    """(reference: load_deepvoxels.py:6-108). Returns
    (imgs, poses, render_poses, [H, W, focal], i_split)."""
    H = W = 512
    deepvoxels_base = f"{basedir}/train/{scene}/"

    full_intrinsic, *_ = _parse_intrinsics(
        os.path.join(deepvoxels_base, "intrinsics.txt"), H
    )
    focal = full_intrinsic[0, 0]

    poses = _dir2poses(os.path.join(deepvoxels_base, "pose"))
    testposes = _dir2poses(f"{basedir}/test/{scene}/pose")[::testskip]
    valposes = _dir2poses(f"{basedir}/validation/{scene}/pose")[::testskip]

    def _load_imgs(d, skip=1):
        files = [f for f in sorted(os.listdir(d)) if f.endswith("png")]
        return np.stack(
            [imread(os.path.join(d, f)) / 255.0 for f in files[::skip]], 0
        ).astype(np.float32)

    imgs = _load_imgs(os.path.join(deepvoxels_base, "rgb"))
    testimgs = _load_imgs(f"{basedir}/test/{scene}/rgb", testskip)
    valimgs = _load_imgs(f"{basedir}/validation/{scene}/rgb", testskip)

    all_imgs = [imgs, valimgs, testimgs]
    counts = np.cumsum([0] + [x.shape[0] for x in all_imgs])
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]

    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate([poses, valposes, testposes], 0)
    render_poses = testposes
    return imgs, poses, render_poses, [H, W, focal], i_split
