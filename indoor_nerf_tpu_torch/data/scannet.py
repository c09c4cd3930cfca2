"""ScanNet indoor dataset loader, copied from indoor_nerf_tpu/data/
scannet.py (reference: PocketNeRF/load_scannet.py).

Reads the nerfstyle_<sceneID> transforms and PNG frames, applies the
OpenCV->NeRF axis flip, and takes the scene bbox from the
`<scene>_vh_clean.ply` mesh bounds (``data/bbox.py::ply_bounds``).
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from indoor_nerf_tpu_torch.data.bbox import ply_bounds
from indoor_nerf_tpu_torch.data.images import half_res as _half_res
from indoor_nerf_tpu_torch.data.images import imread
from indoor_nerf_tpu_torch.data.poses import spherical_render_poses


def load_scannet_data(
    basedir: str,
    sceneID: str,
    half_res: bool = False,
    trainskip: int = 10,
    testskip: int = 1,
) -> Tuple:
    """basedir holds scans/ and nerfstyle_<sceneID>/ (reference:
    load_scannet.py:37-106)."""
    scansdir = os.path.join(basedir, "scans")
    basedir = os.path.join(basedir, "nerfstyle_" + sceneID)

    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = trainskip if s == "train" else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            imgs.append(imread(fname))
            pose = np.array(frame["transform_matrix"])
            # ScanNet uses the OpenCV camera convention
            # (reference: load_scannet.py:67-69).
            pose[:3, 1] *= -1
            pose[:3, 2] *= -1
            poses.append(pose)
        imgs = (np.array(imgs) / 255.0).astype(np.float32)
        poses = np.array(poses).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    camera_angle_x = float(metas["test"]["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    render_poses = spherical_render_poses(40, -30.0, 4.0)

    if half_res:
        H = H // 2
        W = W // 2
        focal = focal / 2.0
        imgs_half = np.zeros((imgs.shape[0], H, W, 3))
        imgs_half[:] = _half_res(imgs)
        imgs = imgs_half.astype(np.float32)

    mn, mx = ply_bounds(
        os.path.join(scansdir, sceneID, f"{sceneID}_vh_clean.ply")
    )
    bounding_box = (tuple((mn - 1.0).tolist()), tuple((mx + 1.0).tolist()))
    return imgs, poses, render_poses, [H, W, focal], i_split, bounding_box
