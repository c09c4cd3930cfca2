"""Host-side ray batches (data/pipeline.py of the JAX package).

``BatchedRaySampler`` (the shuffled pool of every training ray),
``ImageRaySampler`` (``--no_batching``: one image per step, with the central
precrop) and ``UnobservedPatchSampler`` (``--reg_views``: the depth
smoothness patches) are COPIED from the JAX package (:23-76, :206-266,
:79-203): importing them from there pulls in jax through ``ops/rays.py``.
The copies draw the same batches from the same seed
(``tests/test_torch_train_step.py``, ``tests/test_torch_loaders.py``,
``tests/test_torch_reg_patches.py``). ``ImageRaySampler`` keeps its two pixel
grids instead of rebuilding one every step, and ``skip`` makes a step's
draws alone, so that a resumed run replays its sampler quickly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from indoor_nerf_tpu_torch.ops.rays import get_rays_np


class BatchedRaySampler:
    """Shuffled global ray pool (use_batching mode)."""

    def __init__(
        self,
        images: np.ndarray,
        poses: np.ndarray,
        i_train: np.ndarray,
        H: int,
        W: int,
        K: np.ndarray,
        n_rand: int,
        seed: int = 0,
    ):
        rays = np.stack(
            [np.stack(get_rays_np(H, W, K, p[:3, :4]), 0) for p in poses], 0
        )  # [N, 2(ro+rd), H, W, 3]
        rays_rgb = np.concatenate([rays, images[:, None]], 1)  # [N, 3, H, W, 3]
        rays_rgb = np.transpose(rays_rgb, [0, 2, 3, 1, 4])  # [N, H, W, 3, 3]
        rays_rgb = np.stack([rays_rgb[i] for i in i_train], 0)
        # Absolute source-image id per ray (appearance embeddings index
        # the global image table).
        img_ids = np.repeat(
            np.asarray(i_train, np.int32), H * W
        )
        rays_rgb = rays_rgb.reshape(-1, 3, 3).astype(np.float32)
        self._rng = np.random.default_rng(seed)
        perm = self._rng.permutation(rays_rgb.shape[0])
        self.rays_rgb = rays_rgb[perm]
        self.img_ids = img_ids[perm]
        self.n_rand = n_rand
        self.i_batch = 0

    def next(self) -> Dict[str, np.ndarray]:
        batch = self.rays_rgb[self.i_batch : self.i_batch + self.n_rand]
        ids = self.img_ids[self.i_batch : self.i_batch + self.n_rand]
        self.i_batch += self.n_rand
        if self.i_batch >= self.rays_rgb.shape[0]:
            # Epoch reshuffle (reference: run_nerf.py:969-973).
            perm = self._rng.permutation(self.rays_rgb.shape[0])
            self.rays_rgb = self.rays_rgb[perm]
            self.img_ids = self.img_ids[perm]
            self.i_batch = 0
        if batch.shape[0] < self.n_rand:  # wrap the tail to keep shapes fixed
            extra = self.rays_rgb[: self.n_rand - batch.shape[0]]
            batch = np.concatenate([batch, extra], 0)
            ids = np.concatenate(
                [ids, self.img_ids[: self.n_rand - ids.shape[0]]], 0)
        return {
            "rays_o": batch[:, 0],
            "rays_d": batch[:, 1],
            "target": batch[:, 2],
            "img_idx": ids,
        }


class ImageRaySampler:
    """Random-pixels-from-one-image sampler (no_batching mode)."""

    def __init__(
        self,
        images: np.ndarray,
        poses: np.ndarray,
        i_train: np.ndarray,
        H: int,
        W: int,
        K: np.ndarray,
        n_rand: int,
        precrop_iters: int = 0,
        precrop_frac: float = 0.5,
        seed: int = 0,
    ):
        self.images = images
        self.poses = poses
        self.i_train = np.asarray(i_train)
        self.H, self.W, self.K = H, W, K
        self.n_rand = n_rand
        self.precrop_iters = precrop_iters
        self.precrop_frac = precrop_frac
        self._rng = np.random.default_rng(seed)
        # Per-pose ray grids, made on first use (the reference regenerates
        # them every iteration on device, run_nerf.py:983).
        self._ray_cache: Dict[int, tuple] = {}
        # The (row, col) grids of the precrop and of the whole image; the
        # JAX sampler rebuilds its grid every step, from the same values.
        dH = int(H // 2 * precrop_frac)
        dW = int(W // 2 * precrop_frac)
        self._coords = [
            np.stack(np.meshgrid(ys, xs, indexing="ij"), -1).reshape(-1, 2)
            for ys, xs in (
                (np.arange(H // 2 - dH, H // 2 + dH),
                 np.arange(W // 2 - dW, W // 2 + dW)),
                (np.arange(H), np.arange(W)))
        ]

    def _rays_for(self, img_i: int):
        if img_i not in self._ray_cache:
            self._ray_cache[img_i] = get_rays_np(
                self.H, self.W, self.K, self.poses[img_i][:3, :4]
            )
        return self._ray_cache[img_i]

    def _draw(self, step: int):
        """Step ``step``'s two draws: the image, and its pixels' (row, col)."""
        img_i = int(self._rng.choice(self.i_train))
        coords = self._coords[0 if step < self.precrop_iters else 1]
        select = self._rng.choice(
            coords.shape[0], size=self.n_rand, replace=False
        )
        return img_i, coords[select]

    def skip(self, step: int) -> None:
        """Advance the generator past step ``step``'s batch, making no rays."""
        self._draw(step)

    def next(self, step: int) -> Dict[str, np.ndarray]:
        img_i, sc = self._draw(step)  # sc: [n_rand, 2] (row, col)
        target = self.images[img_i]
        rays_o, rays_d = self._rays_for(img_i)
        return {
            "rays_o": rays_o[sc[:, 0], sc[:, 1]].astype(np.float32),
            "rays_d": rays_d[sc[:, 0], sc[:, 1]].astype(np.float32),
            "target": target[sc[:, 0], sc[:, 1]].astype(np.float32),
            "spatial_coords": sc.astype(np.float32),
            "img_idx": np.full(self.n_rand, img_i, np.int32),
        }


class UnobservedPatchSampler:
    """Novel-view ray patches for few-shot geometry regularization
    (RegNeRF-style depth smoothness, Niemeyer et al., CVPR 2022; no
    reference counterpart).

    Novel positions interpolate random training-camera pairs plus isotropic
    jitter; orientations re-aim at the common look-at point, the
    least-squares intersection of the training cameras' optical axes
    (ridge-regularized, so forward-facing rigs degrade gracefully to the
    mean view direction). ``pose_mode="train"`` takes the training cameras
    themselves. Every call returns ``n_patches * patch**2`` rays, one patch
    in ``patch**2`` consecutive rows.
    """

    def __init__(
        self,
        poses: np.ndarray,
        H: int,
        W: int,
        K: np.ndarray,
        n_patches: int,
        patch: int = 8,
        seed: int = 0,
        jitter_frac: float = 0.15,
        pose_mode: str = "novel",
    ):
        if pose_mode not in ("novel", "train"):
            raise ValueError(f"pose_mode must be 'novel' or 'train', got "
                             f"{pose_mode!r}")
        # ``train``: patches come from the TRAINING cameras themselves —
        # the classic monocular depth-smoothness prior. Motivated by the
        # round-5 refutation of the novel-pose mode (BENCH_NOTES round-5
        # few-shot section): in unobserved regions no photometric term
        # opposes the prior, so it converges to degenerate flat geometry;
        # at training poses the photometric loss supplies the opposition.
        self.pose_mode = pose_mode
        cams = np.asarray(poses, np.float64)[:, :3, :4]
        self._cams = cams
        self.H, self.W, self.K = H, W, np.asarray(K, np.float64)
        self.n_patches = int(n_patches)
        self.patch = int(patch)
        if self.patch > min(H, W):
            raise ValueError(f"patch {patch} exceeds image {H}x{W}")
        self.pos = cams[:, :, 3]  # [n, 3]
        # Camera-to-world z column points AWAY from the view direction
        # (get_rays uses -1 z in camera space, ops/rays.py:30).
        look = -cams[:, :, 2]
        look = look / np.linalg.norm(look, axis=-1, keepdims=True)
        # Least-squares point nearest all optical axes:
        #   argmin_x sum_i |(I - d_i d_i^T)(x - p_i)|^2.
        A = np.zeros((3, 3))
        b = np.zeros(3)
        for p, d in zip(self.pos, look):
            M = np.eye(3) - np.outer(d, d)
            A += M
            b += M @ p
        # Ridge so a forward-facing rig (near-parallel axes, singular A)
        # falls back toward cameras-midpoint + mean-direction.
        ridge = 1e-4 * np.trace(A) + 1e-12
        center = np.linalg.solve(A + ridge * np.eye(3), b + ridge * (
            self.pos.mean(0) + look.mean(0) * np.linalg.norm(
                self.pos - self.pos.mean(0), axis=-1).mean()))
        self.center = center
        self.up = cams[:, :, 1].mean(0)
        self.up /= np.linalg.norm(self.up) + 1e-12
        spread = np.linalg.norm(self.pos - self.pos.mean(0), axis=-1)
        self.sigma = jitter_frac * float(spread.mean() + 1e-12)
        self._rng = np.random.default_rng(seed)

    def _novel_c2w(self) -> np.ndarray:
        n = self.pos.shape[0]
        if self.pose_mode == "train":
            return self._cams[self._rng.integers(0, n)]
        a, bi = self._rng.integers(0, n, size=2)
        t = self._rng.uniform()
        p = (1.0 - t) * self.pos[a] + t * self.pos[bi]
        p = p + self._rng.normal(scale=self.sigma, size=3)
        # Look-at frame: z away from the scene center, standard NeRF
        # viewmatrix construction (x = up x z, y = z x x).
        z = p - self.center
        z = z / (np.linalg.norm(z) + 1e-12)
        x = np.cross(self.up, z)
        nx = np.linalg.norm(x)
        if nx < 1e-6:  # camera axis parallel to up: any perpendicular
            x = np.cross(np.array([1.0, 0.0, 0.0]), z)
            nx = np.linalg.norm(x)
        x = x / nx
        y = np.cross(z, x)
        return np.stack([x, y, z, p], axis=-1)  # [3, 4]

    def next(self) -> Dict[str, np.ndarray]:
        ps = self.patch
        K = self.K
        ros, rds = [], []
        for _ in range(self.n_patches):
            c2w = self._novel_c2w()
            u0 = int(self._rng.integers(0, self.W - ps + 1))
            v0 = int(self._rng.integers(0, self.H - ps + 1))
            i, j = np.meshgrid(
                np.arange(u0, u0 + ps, dtype=np.float64),
                np.arange(v0, v0 + ps, dtype=np.float64),
                indexing="xy",
            )
            dirs = np.stack(
                [(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1],
                 -np.ones_like(i)], -1,
            )
            rd = np.sum(dirs[..., np.newaxis, :] * c2w[:3, :3], -1)
            ro = np.broadcast_to(c2w[:3, -1], rd.shape)
            ros.append(ro.reshape(-1, 3))
            rds.append(rd.reshape(-1, 3))
        return {
            "reg_rays_o": np.concatenate(ros, 0).astype(np.float32),
            "reg_rays_d": np.concatenate(rds, 0).astype(np.float32),
        }
