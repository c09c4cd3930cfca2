"""Blender synthetic dataset loader, copied from indoor_nerf_tpu/data/
blender.py (reference: PocketNeRF/load_blender.py); the PNGs are read with
``utils/png.py`` and ``half_res`` is ``data/images.py::half_res``."""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from indoor_nerf_tpu_torch.data.bbox import get_bbox3d_for_blenderobj
from indoor_nerf_tpu_torch.data.images import half_res as _half_res
from indoor_nerf_tpu_torch.data.images import imread
from indoor_nerf_tpu_torch.data.poses import spherical_render_poses


def load_blender_data(
    basedir: str, half_res: bool = False, testskip: int = 1
) -> Tuple:
    """Load transforms_{train,val,test}.json + PNGs.

    Returns (imgs [N,H,W,4] in [0,1], poses [N,4,4], render_poses [40,4,4],
    [H, W, focal], i_split, bounding_box). RGBA is kept; the alpha composite
    happens in ``data/load.py`` (reference: run_nerf.py:771-774).
    """
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
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            imgs.append(imread(fname))
            poses.append(np.array(frame["transform_matrix"]))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)  # keep RGBA
        poses = np.array(poses).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    camera_angle_x = float(metas["train"]["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    render_poses = spherical_render_poses(40, -30.0, 4.0)

    if half_res:
        H = H // 2
        W = W // 2
        focal = focal / 2.0
        imgs = _half_res(imgs)

    bounding_box = get_bbox3d_for_blenderobj(metas["train"], H, W, near=2.0, far=6.0)
    return imgs, poses, render_poses, [H, W, focal], i_split, bounding_box
