"""Benchmark: training-step ray throughput of the port on one CUDA card.

    python -m indoor_nerf_tpu_torch.bench

The counterpart of the root ``bench.py`` (the JAX package's), with the same
configuration (:51-103): the flagship block-hash grid (8 levels x 4
features, 2^13 rows per level, 4^3 tiles, bf16 table IO), a 64^3
transmittance-weighted occupancy grid with an 8-step warm-up, 32 samples
per ray, white background, N_rand 4096, bbox +-1.5, and rays from seed 0
that traverse the bbox (cameras on a radius-4 shell aimed at random
interior points). Steps 0-29 warm up (they build the kernels), as the root
script's compile run does; steps 30-59 are timed, closed by
``torch.cuda.synchronize()``, so the window holds the same training steps
as the root script's: past RAdam's no-update steps and the grid warm-up,
with two grid refreshes (steps 32 and 48). Prints the card on one line, then ONE JSON
line with the root script's keys::

    {"metric": "train_rays_per_sec_per_chip", "value": N,
     "unit": "rays/s/chip", "vs_baseline": N}

``vs_baseline`` divides by the same anchor as the root script (the
reference's ~8533 rays/s GTX 1050 Ti claim). Exits 1 without a CUDA card:
a CPU number is not this metric.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

BASELINE_RAYS_PER_SEC = 5000 * 1024 / 600.0  # the root bench.py's anchor
N_RAND = 4096
N_STEPS = 30


def bench_config():
    """The root bench.py's TrainConfig, built from the port's classes."""
    from indoor_nerf_tpu_torch.models.field import FieldConfig
    from indoor_nerf_tpu_torch.ops.blockhash import BlockHashConfig
    from indoor_nerf_tpu_torch.ops.occupancy import OccupancyConfig
    from indoor_nerf_tpu_torch.render.renderer import RenderConfig
    from indoor_nerf_tpu_torch.train.step import TrainConfig

    bbox = 1.5
    bb = ((-bbox,) * 3, (bbox,) * 3)
    block_grid = BlockHashConfig(
        bbox_min=bb[0], bbox_max=bb[1], n_levels=8, n_features_per_level=4,
        log2_rows=13, base_resolution=16, finest_resolution=512,
        block_size=3, gather_dtype="bfloat16", scatter_dtype="bfloat16",
    )
    occupancy = OccupancyConfig(
        bbox_min=bb[0], bbox_max=bb[1], resolution=64, warmup_steps=8,
        weighting="transmittance",
    )
    fc = FieldConfig(block_grid=block_grid, i_embed=3, n_importance=0)
    rc = RenderConfig(field=fc, n_samples=64, n_importance=0,
                      white_bkgd=True, occupancy=occupancy, n_occ_samples=32)
    return TrainConfig(render=rc, near=2.0, far=6.0, n_rand=N_RAND)


def bench_batch(n_rand: int = N_RAND, bbox: float = 1.5):
    """The root bench.py's numpy ray batch from seed 0."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n_rand, 3))
    o = 4.0 * d / np.linalg.norm(d, axis=-1, keepdims=True)
    aim = rng.uniform(-bbox, bbox, size=(n_rand, 3))
    dirs = aim - o
    return {
        "rays_o": o.astype(np.float32),
        "rays_d": (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
                   ).astype(np.float32),
        "target": rng.uniform(size=(n_rand, 3)).astype(np.float32),
    }


def run() -> dict:
    """Time the steps on ``cuda:0``; returns the JSON line's dict."""
    import torch

    import indoor_nerf_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from indoor_nerf_tpu_torch.train.step import init_train_state, train_step

    dev = torch.device("cuda:0")
    cfg = bench_config()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in bench_batch().items()}
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    for _ in range(N_STEPS):  # warm-up (builds kernels)
        state, metrics = train_step(state, batch, cfg, gen)
    float(metrics["loss"])
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(N_STEPS):
        state, metrics = train_step(state, batch, cfg, gen)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {loss}")
    rays_per_sec = N_RAND * N_STEPS / dt  # one card
    print(f"bench: {torch.cuda.get_device_name(0)}; {N_STEPS} steps in "
          f"{dt:.4f} s; last loss {loss:.6f}")
    return {
        "metric": "train_rays_per_sec_per_chip",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s/chip",
        "vs_baseline": round(rays_per_sec / BASELINE_RAYS_PER_SEC, 2),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench: no CUDA device (torch.cuda.is_available() is False); "
              "the metric is the card's", file=sys.stderr)
        return 1
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
