"""Host-side ray batches (data/pipeline.py of the JAX package).

``BatchedRaySampler`` (the shuffled pool of every training ray) and
``ImageRaySampler`` (``--no_batching``: one image per step, with the central
precrop) are COPIED from the JAX package (:23-76, :206-266): importing them
from there pulls in jax through ``ops/rays.py``. The copies draw the same
batches from the same seed (``tests/test_torch_train_step.py``,
``tests/test_torch_loaders.py``). ``ImageRaySampler`` keeps its two pixel
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
