"""LINEMOD dataset loader, copied from indoor_nerf_tpu/data/linemod.py
(reference: PocketNeRF/load_LINEMOD.py); images through ``data/images.py``."""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from indoor_nerf_tpu_torch.data.images import half_res as _half_res
from indoor_nerf_tpu_torch.data.images import imread
from indoor_nerf_tpu_torch.data.poses import spherical_render_poses


def load_LINEMOD_data(basedir: str, half_res: bool = False, testskip: int = 1
                      ) -> Tuple:
    """Returns (imgs, poses, render_poses, [H, W, focal], K, i_split, near,
    far): the test split's first intrinsic matrix and the metadata's
    near/far (floor and ceil). ``file_path`` is read as it stands."""
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if s == "train" or testskip == 0 else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            imgs.append(imread(frame["file_path"]))
            poses.append(np.array(frame["transform_matrix"]))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)
        poses = np.array(poses).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    focal = float(metas["test"]["frames"][0]["intrinsic_matrix"][0][0])
    K = metas["test"]["frames"][0]["intrinsic_matrix"]

    render_poses = spherical_render_poses(40, -30.0, 4.0)

    if half_res:
        H = H // 2
        W = W // 2
        focal = focal / 2.0
        imgs_half = np.zeros((imgs.shape[0], H, W, 3))
        imgs_half[:] = _half_res(imgs)
        imgs = imgs_half.astype(np.float32)

    near = np.floor(min(metas["train"]["near"], metas["test"]["near"]))
    far = np.ceil(max(metas["train"]["far"], metas["test"]["far"]))
    return imgs, poses, render_poses, [H, W, focal], K, i_split, near, far
