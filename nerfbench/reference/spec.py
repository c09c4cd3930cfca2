"""A configuration's model, renderer and optimizer settings, read from the
configuration's flags with the reference's own defaults (the published
PocketNeRF/HashNeRF values the program's parser also uses), and the scene
box from the scene's cameras."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

import numpy as np

# Defaults of the flags a configuration file may leave out.
DEFAULTS = {
    "i_embed": 1, "n_levels": 16, "feats_per_level": 2,
    "log2_hashmap_size": 19, "finest_res": 512, "block_size": 4,
    "block_io": "f32", "N_samples": 64, "N_importance": 0,
    "use_occupancy": False, "occ_resolution": 64, "occ_samples": 64,
    "occ_candidates": 128, "occ_update_interval": 16,
    "occ_weighting": "density", "occ_mix": 0.15, "N_rand": 1024,
    "lrate": 5e-4, "lrate_decay": 250, "sparse-loss-weight": 1e-10,
    "tv-loss-weight": 1e-6, "use_viewdirs": False, "white_bkgd": False,
    "predict_normals": False, "use_structural_priors": False,
    "planarity_weight": 0.005, "manhattan_weight": 0.002,
    "normal_consistency_weight": 0.001, "structural_loss_start_iter": 2000,
    "structural_loss_ramp_iters": 1000, "perturb": 1.0, "raw_noise_std": 0.0,
}
NEAR, FAR = 2.0, 6.0  # the Blender layout's fixed bounds
TV_CUTOFF = 1000  # TV weighs only up to this step


@dataclasses.dataclass(frozen=True)
class Spec:
    bbox_min: Tuple[float, float, float]
    bbox_max: Tuple[float, float, float]
    grid: str  # "block" or "hash"
    n_levels: int
    n_features: int
    log2_rows: int  # rows per level of the table: 2**log2_rows
    finest_res: int
    block_size: int  # block grid only
    gather_bf16: bool  # block grid: the forward reads bf16 rows
    scatter_bf16: bool  # block grid: the cotangent is rounded to bf16
    n_samples: int
    n_importance: int
    occupancy: bool
    occ_resolution: int
    occ_samples: int
    occ_candidates: int
    occ_interval: int
    occ_transmittance: bool
    occ_mix: float
    n_rand: int
    lrate: float
    lrate_decay: int
    sparse_w: float
    tv_w: float
    white_bkgd: bool
    normals: bool
    priors: bool
    prior_weights: Dict[str, float]
    prior_start: int
    prior_ramp: int
    hidden: int = 64
    geo: int = 15
    base_res: int = 16
    occ_decay: float = 0.95
    occ_fraction: float = 0.25
    occ_floor: float = 1e-2
    occ_warmup: int = 256
    # The control: every matrix product's operands rounded to TF32 (10
    # mantissa bits), the products summed in float32.
    tf32: bool = False

    @property
    def side(self) -> int:
        return self.block_size + 1

    @property
    def lanes(self) -> int:
        return 128 if self.side ** 3 > 64 else 64

    @property
    def rows(self) -> int:
        return 1 << self.log2_rows

    @property
    def table_shape(self) -> Tuple[int, int]:
        if self.grid == "block":
            return (self.n_levels * self.rows, self.n_features * self.lanes)
        return (self.n_levels * self.rows, self.n_features)

    @property
    def nets(self) -> Tuple[str, ...]:
        return ("coarse", "fine") if self.n_importance > 0 else ("coarse",)

    @property
    def samples_per_ray(self) -> int:
        """Field queries a ray takes, both passes counted."""
        if self.occupancy:
            return self.occ_samples
        return self.n_samples * 2 + self.n_importance if self.n_importance \
            else self.n_samples


def blender_bbox(datadir: str, near: float = NEAR, far: float = FAR):
    """(box min, box max, focal, image width) of a Blender-layout scene: the
    box is the hull of the four corner rays of every training camera at
    near and far, padded by 1 (HashNeRF's ``get_bbox3d_for_blenderobj``),
    the focal length the one ``camera_angle_x`` gives at the images'
    width."""
    with open(os.path.join(datadir, "transforms_train.json")) as f:
        meta = json.load(f)
    with open(os.path.join(datadir, "train",
                           os.path.basename(meta["frames"][0]["file_path"])
                           + ".png"), "rb") as f:
        head = f.read(24)
    W, H = int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - W / 2) / focal, -(j - H / 2) / focal,
                     -np.ones_like(i)], -1)
    pts = []
    for frame in meta["frames"]:
        c2w = np.array(frame["transform_matrix"], np.float32)
        d = dirs @ c2w[:3, :3].T
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).reshape(-1, 3)
        o = np.broadcast_to(c2w[:3, -1], d.shape)
        for k in (0, W - 1, H * W - W, H * W - 1):
            pts.append(o[k] + near * d[k])
            pts.append(o[k] + far * d[k])
    pts = np.stack(pts)
    mn, mx = pts.min(axis=0), pts.max(axis=0)
    return (tuple((mn - 1.0).tolist()), tuple((mx + 1.0).tolist()),
            float(focal), W)


def make_spec(args: Dict, bbox) -> Spec:
    """The reference's settings from a configuration's flags ``args`` (key
    = value as in a config file) and the scene box ``(min, max)``."""
    a = dict(DEFAULTS)
    a.update(args)
    grid = {3: "block", 1: "hash"}.get(int(a["i_embed"]))
    if grid is None:
        raise ValueError(f"i_embed {a['i_embed']}: the reference holds the "
                         "block-hash grid (3) and the hash grid (1)")
    L, F = int(a["n_levels"]), int(a["feats_per_level"])
    bs = int(a["block_size"])
    if grid == "block":
        # Capacity parity with a 2**log2_hashmap_size-entry hash table at
        # equal float budget across (L, F).
        lf_shift = int(np.round(np.log2((L * F) / 32.0)))
        log2_rows = max(4, int(a["log2_hashmap_size"]) - (7 if bs == 4 else 6)
                        - lf_shift)
    else:
        log2_rows = int(a["log2_hashmap_size"])
    normals = bool(a["predict_normals"] or a["use_structural_priors"])
    return Spec(
        bbox_min=tuple(bbox[0]), bbox_max=tuple(bbox[1]), grid=grid,
        n_levels=L, n_features=F, log2_rows=log2_rows,
        finest_res=int(a["finest_res"]), block_size=bs,
        gather_bf16=a["block_io"] in ("bf16",),
        scatter_bf16=a["block_io"] in ("bf16", "int8"),
        n_samples=int(a["N_samples"]), n_importance=int(a["N_importance"]),
        occupancy=bool(a["use_occupancy"]),
        occ_resolution=int(a["occ_resolution"]),
        occ_samples=int(a["occ_samples"]),
        occ_candidates=int(a["occ_candidates"]),
        occ_interval=int(a["occ_update_interval"]),
        occ_transmittance=a["occ_weighting"] == "transmittance",
        occ_mix=float(a["occ_mix"]), n_rand=int(a["N_rand"]),
        lrate=float(a["lrate"]), lrate_decay=int(a["lrate_decay"]),
        sparse_w=float(a["sparse-loss-weight"]),
        tv_w=float(a["tv-loss-weight"]), white_bkgd=bool(a["white_bkgd"]),
        normals=normals, priors=bool(a["use_structural_priors"]) and normals,
        prior_weights={"planarity": float(a["planarity_weight"]),
                       "manhattan": float(a["manhattan_weight"]),
                       "normal_consistency": float(a["normal_consistency_weight"])},
        prior_start=int(a["structural_loss_start_iter"]),
        prior_ramp=int(a["structural_loss_ramp_iters"]))


def level_resolutions(n_levels: int, base: int, finest: int) -> np.ndarray:
    """Per-level grid resolutions ``floor(base * b**l)``, b the geometric
    growth from ``base`` to ``finest``, in float32."""
    base32, finest32 = np.float32(base), np.float32(finest)
    b = (np.exp((np.log(finest32) - np.log(base32)) / np.float32(n_levels - 1))
         .astype(np.float32) if n_levels > 1 else np.float32(1.0))
    return np.floor(base32 * b ** np.arange(n_levels, dtype=np.float32)
                    ).astype(np.float32)

