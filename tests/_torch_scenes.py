"""Tiny scenes on disk, one per dataset type of the file loaders, written by
the port's own writers (``data/scene_files.py``, ``utils/png.py``) for the
tests that compare the loaders and train from files."""

import json
import os

import numpy as np

from indoor_nerf_tpu_torch.data.scene_files import (
    make_plane_scene,
    make_sphere_scene,
    write_blender_scene,
    write_llff_scene,
)
from indoor_nerf_tpu_torch.utils.png import encode_png


def random_image(rng, h, w, c):
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    return img[..., 0] if c == 1 else img


def write_frames(rng, d, names, h=12, w=14, c=3):
    for name in names:
        with open(os.path.join(d, name), "wb") as f:
            f.write(encode_png(random_image(rng, h, w, c)))


def random_pose(rng):
    m = np.eye(4)
    m[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    m[:3, 3] = rng.normal(size=3) * 2
    return m.tolist()


def write_blender(root, n_views=24, size=24):
    """The sphere in the Blender layout: even views train, odd val/test."""
    write_blender_scene(str(root), make_sphere_scene(n_views, size, size))
    return str(root)


def write_llff(root, c2ws=None):
    """The plane seen by 16 cameras, 96x128 in images/, 12x16 in images_8/."""
    write_llff_scene(str(root), make_plane_scene(16) if c2ws is None else c2ws,
                     96, 128, 120.0, 8)
    return str(root)


def write_scannet(root, h=12, w=14):
    """scans/<scene>/<scene>_vh_clean.ply (binary) + nerfstyle_<scene>/
    with 21 train frames (trainskip 10 keeps 3) and 2 val, 2 test."""
    rng = np.random.default_rng(4)
    scene = "scene0000_00"
    nerf = os.path.join(root, f"nerfstyle_{scene}")
    os.makedirs(nerf)
    for split, n in (("train", 21), ("val", 2), ("test", 2)):
        names = [f"{split}_{i}" for i in range(n)]
        write_frames(rng, nerf, [f"{n}.png" for n in names], h, w)
        with open(os.path.join(nerf, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.9, "frames": [
                {"file_path": n, "transform_matrix": random_pose(rng)}
                for n in names]}, f)
    scans = os.path.join(root, "scans", scene)
    os.makedirs(scans)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    with open(os.path.join(scans, f"{scene}_vh_clean.ply"), "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 50\n"
                b"property float x\nproperty float y\nproperty float z\n"
                b"end_header\n" + pts.tobytes())
    return str(root)


def write_linemod(root):
    rng = np.random.default_rng(5)
    K = [[30.0, 0, 7], [0, 30.0, 6], [0, 0, 1]]
    for split, n in (("train", 3), ("val", 2), ("test", 3)):
        names = [os.path.join(root, f"{split}_{i}.png") for i in range(n)]
        write_frames(rng, root, names, c=4)
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"near": 1.3, "far": 5.2, "frames": [
                {"file_path": n, "transform_matrix": random_pose(rng),
                 "intrinsic_matrix": K} for n in names]}, f)
    return str(root)


def write_deepvoxels(root, shape="greek"):
    rng = np.random.default_rng(6)
    for split, n in (("train", 3), ("validation", 4), ("test", 4)):
        base = os.path.join(root, split, shape)
        os.makedirs(os.path.join(base, "pose"))
        os.makedirs(os.path.join(base, "rgb"))
        if split == "train":
            with open(os.path.join(base, "intrinsics.txt"), "w") as f:
                f.write("350.0 256.0 256.0\n0.0 0.0 0.0\n0.8\n1.0\n"
                        "512. 512.\n0\n")
        for i in range(n):
            with open(os.path.join(base, "pose", f"{i:03d}.txt"), "w") as f:
                f.write(" ".join(str(v) for v in np.ravel(random_pose(rng))))
        write_frames(rng, os.path.join(base, "rgb"),
                     [f"{i:03d}.png" for i in range(n)])
    return str(root)


WRITERS = {"blender": write_blender, "llff": write_llff,
           "scannet": write_scannet, "LINEMOD": write_linemod,
           "deepvoxels": write_deepvoxels}
