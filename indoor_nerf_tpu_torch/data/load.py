"""Dataset dispatch (data/load.py of the JAX package, the whole of it).

``load_dataset`` loads ``--dataset_type`` blender, llff, scannet, LINEMOD,
deepvoxels or synthetic through the port's copies of the JAX loaders and
derives what the JAX one derives (reference: PocketNeRF/run_nerf.py:
730-823): near/far per type (blender 2/6, scannet 0.1/10, LINEMOD from its
metadata, deepvoxels the hemisphere radius -/+ 1, LLFF 0/1 in NDC or the
bounds' 0.9 min / max with ``--no_ndc``), LLFF's ``--llffhold`` split, the
white-background composite, ``K`` from ``hwf`` where the loader gives none,
``render_poses`` of the test views under ``--render_test``, and the scene
bounding box (none for LINEMOD and deepvoxels, which the block-hash grid
then refuses).
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
    bounding_box: Optional[Tuple]  # ((min3), (max3)) or None (PE-only datasets)
    ndc: bool = False
    bds: Optional[np.ndarray] = None


def _as_tuple_bbox(bounding_box) -> Tuple:
    mn, mx = bounding_box
    return tuple(np.asarray(mn, np.float64).tolist()), tuple(
        np.asarray(mx, np.float64).tolist()
    )


def load_dataset(args) -> SceneData:
    """args: the parsed CLI namespace (train/config.py)."""
    K = None
    bds = None
    ndc = False

    if args.dataset_type == "llff":
        from indoor_nerf_tpu_torch.data.llff import load_llff_data

        images, poses, bds, render_poses, i_test, bounding_box = load_llff_data(
            args.datadir, args.factor, recenter=True, bd_factor=0.75,
            spherify=args.spherify,
        )
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        print("Loaded llff", images.shape, render_poses.shape, hwf, args.datadir)

        if not isinstance(i_test, list):
            i_test = [i_test]
        if args.llffhold > 0:
            print("Auto LLFF holdout,", args.llffhold)
            i_test = np.arange(images.shape[0])[:: args.llffhold]
        i_val = i_test
        i_train = np.array(
            [i for i in np.arange(int(images.shape[0]))
             if (i not in i_test and i not in i_val)]
        )

        if args.no_ndc:
            near = np.ndarray.min(bds) * 0.9
            far = np.ndarray.max(bds) * 1.0
        else:
            near = 0.0
            far = 1.0
            ndc = True
        print("NEAR FAR", near, far)

    elif args.dataset_type == "blender":
        from indoor_nerf_tpu_torch.data.blender import load_blender_data

        images, poses, render_poses, hwf, i_split, bounding_box = (
            load_blender_data(args.datadir, args.half_res, args.testskip)
        )
        print("Loaded blender", images.shape, render_poses.shape, hwf, args.datadir)
        i_train, i_val, i_test = i_split
        near, far = 2.0, 6.0
        if args.white_bkgd:
            images = images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
        else:
            images = images[..., :3]

    elif args.dataset_type == "scannet":
        from indoor_nerf_tpu_torch.data.scannet import load_scannet_data

        images, poses, render_poses, hwf, i_split, bounding_box = (
            load_scannet_data(args.datadir, args.scannet_sceneID, args.half_res)
        )
        print("Loaded scannet", images.shape, render_poses.shape, hwf, args.datadir)
        i_train, i_val, i_test = i_split
        near, far = 0.1, 10.0

    elif args.dataset_type == "LINEMOD":
        from indoor_nerf_tpu_torch.data.linemod import load_LINEMOD_data

        images, poses, render_poses, hwf, K, i_split, near, far = (
            load_LINEMOD_data(args.datadir, args.half_res, args.testskip)
        )
        print(f"Loaded LINEMOD, images shape: {images.shape}, hwf: {hwf}, K: {K}")
        i_train, i_val, i_test = i_split
        bounding_box = None
        if args.white_bkgd:
            images = images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
        else:
            images = images[..., :3]

    elif args.dataset_type == "deepvoxels":
        from indoor_nerf_tpu_torch.data.deepvoxels import load_dv_data

        images, poses, render_poses, hwf, i_split = load_dv_data(
            scene=args.shape, basedir=args.datadir, testskip=args.testskip
        )
        print("Loaded deepvoxels", images.shape, render_poses.shape, hwf,
              args.datadir)
        i_train, i_val, i_test = i_split
        hemi_r = np.mean(np.linalg.norm(poses[:, :3, -1], axis=-1))
        near = hemi_r - 1.0
        far = hemi_r + 1.0
        bounding_box = None

    elif args.dataset_type == "synthetic":
        # Built-in procedural scenes (no external data needed; not in the
        # reference — used for smoke runs and benchmarks).
        # --synthetic_variant room: indoor Manhattan room (checker floor,
        # walls, boxes) for structural-prior experiments;
        # --synthetic_n_views/--synthetic_res/--synthetic_n_train control
        # view count, resolution and the few-shot split.
        from indoor_nerf_tpu_torch.data.synthetic import (
            make_room_scene,
            make_synthetic_scene,
        )

        n_views = getattr(args, "synthetic_n_views", None) or 12
        res = getattr(args, "synthetic_res", None) or 64
        n_train = getattr(args, "synthetic_n_train", None)
        if getattr(args, "synthetic_variant", "sphere") == "room":
            scene = make_room_scene(n_views=n_views, H=res, W=res,
                                    n_train=n_train)
        else:
            scene = make_synthetic_scene(n_views=n_views, H=res, W=res)
        images = scene["images"]
        poses = scene["poses"]
        render_poses = scene["poses"][:4]
        hwf = scene["hwf"]
        K = scene["K"]
        i_train, i_val, i_test = scene["i_split"]
        near, far = scene["near"], scene["far"]
        bounding_box = (scene["bbox_min"], scene["bbox_max"])

    else:
        raise ValueError(f"Unknown dataset type {args.dataset_type}")

    H, W, focal = hwf
    H, W = int(H), int(W)
    hwf = [H, W, focal]
    if K is None:
        K = np.array(
            [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]]
        )
    K = np.asarray(K, np.float64)

    if args.render_test:
        render_poses = np.array(poses[i_test])

    return SceneData(
        images=np.asarray(images, np.float32),
        poses=np.asarray(poses, np.float32),
        render_poses=np.asarray(render_poses, np.float32),
        hwf=hwf,
        K=K,
        i_train=np.asarray(i_train),
        i_val=np.asarray(i_val),
        i_test=np.asarray(i_test),
        near=float(near),
        far=float(far),
        bounding_box=None if bounding_box is None else _as_tuple_bbox(bounding_box),
        ndc=ndc,
        bds=bds,
    )
