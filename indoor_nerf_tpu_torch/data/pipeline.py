"""Host-side ray batches (data/pipeline.py of the JAX package).

``BatchedRaySampler`` is COPIED from the JAX package (:23-76): importing it
from there pulls in jax through ``ops/rays.py``. The copy draws the same
batches from the same seed (``tests/test_torch_train_step.py``). The
per-image sampler (``--no_batching``) comes with ROADMAP.md Queue 1 item 3.
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
