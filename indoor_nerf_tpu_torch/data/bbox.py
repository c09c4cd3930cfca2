"""Scene bounding-box estimators (host-side numpy), copied from
indoor_nerf_tpu/data/bbox.py (whose package imports jax).

The scene AABB is the hull of the camera-frustum corner rays evaluated at
near and far, padded by a margin (reference: PocketNeRF/utils.py:27-92);
``ply_bounds`` reads a ScanNet mesh's vertex bounds.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from indoor_nerf_tpu_torch.ops.rays import (
    get_ndc_rays_np,
    get_ray_directions_np,
    get_rays_from_directions_np,
)

Bounds = Tuple[Tuple[float, float, float], Tuple[float, float, float]]


def _frusta_bounds(points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return points.min(axis=0), points.max(axis=0)


def get_bbox3d_for_blenderobj(
    camera_transforms: Dict, H: int, W: int, near: float = 2.0, far: float = 6.0
) -> Bounds:
    """AABB over the 4 corner rays of every training frustum
    (reference: utils.py:27-58), padded by 1.0 on each side."""
    camera_angle_x = float(camera_transforms["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    directions = get_ray_directions_np(H, W, focal)

    pts = []
    corner_idx = [0, W - 1, H * W - W, H * W - 1]
    for frame in camera_transforms["frames"]:
        c2w = np.array(frame["transform_matrix"], np.float32)
        rays_o, rays_d = get_rays_from_directions_np(directions, c2w)
        for i in corner_idx:
            pts.append(rays_o[i] + near * rays_d[i])
            pts.append(rays_o[i] + far * rays_d[i])
    mn, mx = _frusta_bounds(np.stack(pts))
    return tuple((mn - 1.0).tolist()), tuple((mx + 1.0).tolist())


def get_bbox3d_for_llff(
    poses: np.ndarray, hwf, near: float = 0.0, far: float = 1.0
) -> Bounds:
    """NDC-space AABB for LLFF forward-facing scenes
    (reference: utils.py:61-92), padded by (0.1, 0.1, 0.0001)."""
    H, W, focal = hwf
    H, W = int(H), int(W)
    directions = get_ray_directions_np(H, W, focal)

    pts = []
    corner_idx = [0, W - 1, H * W - W, H * W - 1]
    for pose in np.asarray(poses, np.float32):
        rays_o, rays_d = get_rays_from_directions_np(directions, pose)
        rays_o, rays_d = get_ndc_rays_np(H, W, focal, 1.0, rays_o, rays_d)
        for i in corner_idx:
            pts.append(rays_o[i] + near * rays_d[i])
            pts.append(rays_o[i] + far * rays_d[i])
    mn, mx = _frusta_bounds(np.stack(pts))
    pad = np.array([0.1, 0.1, 0.0001])
    return tuple((mn - pad).tolist()), tuple((mx + pad).tolist())


def ply_bounds(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Vertex-position bounds of a PLY mesh (ascii or binary_little_endian).

    Replaces the reference's pyvista dependency for the ScanNet scene bbox
    (reference: load_scannet.py:103-105) with a minimal self-contained parser
    that only reads the vertex x/y/z properties.
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        n_vertex = 0
        props = []  # (name, dtype) of vertex properties in order
        in_vertex = False
        type_map = {
            b"float": "<f4", b"float32": "<f4", b"double": "<f8",
            b"float64": "<f8", b"uchar": "u1", b"uint8": "u1",
            b"char": "i1", b"int8": "i1", b"short": "<i2", b"ushort": "<u2",
            b"int": "<i4", b"int32": "<i4", b"uint": "<u4", b"uint32": "<u4",
        }
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1]
            elif line.startswith(b"element"):
                parts = line.split()
                in_vertex = parts[1] == b"vertex"
                if in_vertex:
                    n_vertex = int(parts[2])
            elif line.startswith(b"property") and in_vertex:
                parts = line.split()
                if parts[1] == b"list":
                    raise ValueError("list property in vertex element")
                props.append((parts[2].decode(), type_map[parts[1]]))
            elif line == b"end_header":
                break

        if fmt == b"ascii":
            names = [p[0] for p in props]
            data = np.loadtxt(f, max_rows=n_vertex)
            xyz = data[:, [names.index("x"), names.index("y"), names.index("z")]]
        elif fmt == b"binary_little_endian":
            dt = np.dtype([(name, t) for name, t in props])
            data = np.frombuffer(f.read(n_vertex * dt.itemsize), dtype=dt,
                                 count=n_vertex)
            xyz = np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float64)
        else:
            raise ValueError(f"unsupported PLY format {fmt!r}")
    return xyz.min(axis=0), xyz.max(axis=0)
