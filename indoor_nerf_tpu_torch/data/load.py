"""Dataset dispatch (data/load.py of the JAX package), synthetic scenes only.

The five file-based loaders (blender, llff, scannet, LINEMOD, deepvoxels)
come with ROADMAP.md Queue 1 item 3 (trainer, CLI and loaders).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SceneData:
    images: np.ndarray  # [N, H, W, 3] float32 in [0, 1]
    poses: np.ndarray  # [N, 3or4, 4]
    render_poses: np.ndarray
    hwf: List
    K: np.ndarray
    i_train: np.ndarray
    i_val: np.ndarray
    i_test: np.ndarray
    near: float
    far: float
    bounding_box: Optional[Tuple]  # ((min3), (max3)) or None
    ndc: bool = False
    bds: Optional[np.ndarray] = None


def _as_tuple_bbox(bounding_box) -> Tuple:
    mn, mx = bounding_box
    return tuple(np.asarray(mn, np.float64).tolist()), tuple(
        np.asarray(mx, np.float64).tolist()
    )


def load_dataset(args) -> SceneData:
    """args: the parsed CLI namespace (train.config)."""
    if args.dataset_type != "synthetic":
        raise NotImplementedError(
            f"dataset_type {args.dataset_type!r}: the file-based loaders come "
            "with ROADMAP.md Queue 1 item 3 (trainer, CLI and loaders); the "
            "port loads --dataset_type synthetic")
    from indoor_nerf_tpu_torch.data.synthetic import (
        make_room_scene,
        make_synthetic_scene,
    )

    n_views = getattr(args, "synthetic_n_views", None) or 12
    res = getattr(args, "synthetic_res", None) or 64
    n_train = getattr(args, "synthetic_n_train", None)
    if getattr(args, "synthetic_variant", "sphere") == "room":
        scene = make_room_scene(n_views=n_views, H=res, W=res, n_train=n_train)
    else:
        scene = make_synthetic_scene(n_views=n_views, H=res, W=res)
    poses = scene["poses"]
    render_poses = poses[:4]
    i_train, i_val, i_test = scene["i_split"]
    H, W, focal = scene["hwf"]
    if args.render_test:
        render_poses = np.array(poses[i_test])

    return SceneData(
        images=np.asarray(scene["images"], np.float32),
        poses=np.asarray(poses, np.float32),
        render_poses=np.asarray(render_poses, np.float32),
        hwf=[int(H), int(W), focal],
        K=np.asarray(scene["K"], np.float64),
        i_train=np.asarray(i_train),
        i_val=np.asarray(i_val),
        i_test=np.asarray(i_test),
        near=float(scene["near"]),
        far=float(scene["far"]),
        bounding_box=_as_tuple_bbox((scene["bbox_min"], scene["bbox_max"])),
    )
