"""``dryrun_multichip(n)``: the whole training step and the sharded
renderer over an n-rank ``data x model`` mesh of processes (the analogue
of ``__graft_entry__.py::dryrun_multichip`` of the JAX package).

    python -m indoor_nerf_tpu_torch.parallel.dryrun 4 [--device cpu]

spawns n processes joined over Gloo (a file rendezvous in a temporary
directory), each on card ``rank % cards`` (Gloo takes the card's tensors,
so several ranks may share one card) or, with ``--device cpu``, on the
CPU; lays them out as ``data:n/2 x model:2``, and in each runs one
step of a tiny hash-grid setup (the hierarchical fine pass) and one of the
tiny flagship (block-hash bf16 encode, transmittance occupancy sampling,
the distortion loss) with the table and its moments level-sharded over the
model axis, checks the shards' shapes and renders an 8x8 image through the
sharded renderer with the model-sharded table. It prints one line.
"""

from __future__ import annotations

import argparse
import math
import multiprocessing
import os
import queue
import tempfile
from datetime import timedelta
from typing import Dict, Tuple

import numpy as np
import torch

TIMEOUT_S = 120


def tiny_setup(n_rand: int, flagship: bool, device: torch.device):
    """(TrainConfig, seeded train state, batch) of ``__graft_entry__.py::
    _tiny_setup`` at 4 levels, on ``device``."""
    from indoor_nerf_tpu_torch.models.field import FieldConfig
    from indoor_nerf_tpu_torch.ops.blockhash import BlockHashConfig
    from indoor_nerf_tpu_torch.ops.encoding import HashGridConfig
    from indoor_nerf_tpu_torch.ops.occupancy import OccupancyConfig
    from indoor_nerf_tpu_torch.render.renderer import RenderConfig
    from indoor_nerf_tpu_torch.train.step import TrainConfig, init_train_state

    box = dict(bbox_min=(-1.5,) * 3, bbox_max=(1.5,) * 3)
    if flagship:
        bg = BlockHashConfig(**box, n_levels=4, n_features_per_level=4,
                             log2_rows=8, base_resolution=16,
                             finest_resolution=64, block_size=3,
                             gather_dtype="bfloat16",
                             scatter_dtype="bfloat16")
        occ = OccupancyConfig(**box, resolution=8, warmup_steps=2,
                              n_candidates=16, update_interval=1,
                              weighting="transmittance")
        fc = FieldConfig(block_grid=bg, i_embed=3, n_importance=0)
        rc = RenderConfig(field=fc, n_samples=8, n_importance=0,
                          white_bkgd=True, occupancy=occ, n_occ_samples=4)
        cfg = TrainConfig(render=rc, near=2.0, far=6.0, n_rand=n_rand,
                          distortion_loss_weight=1e-3)
    else:
        grid = HashGridConfig(**box, n_levels=4, log2_hashmap_size=10,
                              base_resolution=16, finest_resolution=64)
        fc = FieldConfig(grid=grid, i_embed=1, n_importance=8)
        rc = RenderConfig(field=fc, n_samples=8, n_importance=8,
                          white_bkgd=True)
        cfg = TrainConfig(render=rc, near=2.0, far=6.0, n_rand=n_rand,
                          tv_loss_weight=1e-6)
    state = init_train_state(torch.Generator(device=device).manual_seed(0),
                             cfg, device)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n_rand, 3)).astype(np.float32)
    batch = {
        "rays_o": torch.zeros((n_rand, 3)),
        "rays_d": torch.from_numpy(d / np.linalg.norm(d, axis=-1,
                                                      keepdims=True)),
        "target": torch.from_numpy(
            rng.uniform(size=(n_rand, 3)).astype(np.float32)),
    }
    return cfg, state, {k: v.to(device) for k, v in batch.items()}


def _one_step(mesh, n_rand: int, flagship: bool,
              device: torch.device) -> Tuple[float, Dict]:
    """One sharded step of ``tiny_setup``: (loss, state after it)."""
    from indoor_nerf_tpu_torch.parallel.shard import (
        make_sharded_train_step,
        shard_state,
    )

    cfg, state, batch = tiny_setup(n_rand, flagship, device)
    n_local = n_rand // mesh.size("data")
    d = mesh.index("data")
    local = {k: v[d * n_local:(d + 1) * n_local] for k, v in batch.items()}
    full_rows = state["params"]["table"].shape[0]
    state = shard_state(state, mesh)
    step = make_sharded_train_step(cfg, mesh)
    state, metrics = step(state, local,
                          torch.Generator(device=device).manual_seed(3))
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {loss}")
    rows = full_rows // mesh.size("model")
    for leaf in (state["params"]["table"], state["opt"]["mu"]["table"],
                 state["opt"]["nu"]["table"]):
        if leaf.shape[0] != rows:
            raise AssertionError(f"table shard {tuple(leaf.shape)}; expected "
                                 f"{rows} rows of {full_rows}")
    return loss, {"cfg": cfg, "state": state}


def _child(rank: int, world: int, rdv: str, device: str,
           out: "multiprocessing.Queue"):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{rdv}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=TIMEOUT_S))
        from indoor_nerf_tpu_torch.parallel.shard import make_mesh
        from indoor_nerf_tpu_torch.parallel.sp import (
            make_sharded_image_renderer,
        )

        mesh = make_mesh(("data", "model"), (world // 2, 2))
        n_rand = 16 * world
        loss, _ = _one_step(mesh, n_rand, False, dev)
        loss2, run = _one_step(mesh, n_rand, True, dev)
        H = W = 8
        K = np.array([[8.0, 0, W / 2], [0, 8.0, H / 2], [0, 0, 1]],
                     np.float32)
        c2w = np.eye(4, dtype=np.float32)[:3]
        c2w[2, 3] = 4.0
        render = make_sharded_image_renderer(
            run["cfg"].render, H, W, mesh, tile_rays=8, model_axis="model")
        img = render(run["state"]["params"], c2w, K, 2.0, 6.0,
                     occ_state=run["state"]["occ"])["rgb_map"]
        if img.shape != (H, W, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"sharded render {tuple(img.shape)}")
        out.put((rank, "ok", loss, loss2))
    except Exception as e:  # reported to the parent, which raises
        out.put((rank, f"{type(e).__name__}: {e}", None, None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda") -> str:
    """Run the dry run on ``n_devices`` processes (even, at least 4) on the
    cards (``device="cuda"``, raising where none is visible) or on the CPU
    (``device="cpu"``), and return its line (also printed)."""
    if n_devices < 4 or n_devices % 2:
        raise ValueError(f"dryrun_multichip needs an even n >= 4 for the "
                         f"data:n/2 x model:2 mesh, got {n_devices}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no card is visible; pass "
                           "device='cpu' (--device cpu) to run on the CPU")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        rdv = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_child,
                             args=(r, n_devices, rdv, device, results))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        got = {}
        try:
            for _ in range(n_devices):
                rank, status, loss, loss2 = results.get(
                    timeout=2 * TIMEOUT_S)
                got[rank] = (status, loss, loss2)
        except queue.Empty:
            raise TimeoutError(f"dryrun_multichip: {len(got)} of "
                               f"{n_devices} ranks reported") from None
        finally:
            for p in procs:
                p.join(timeout=TIMEOUT_S)
                if p.is_alive():
                    p.kill()
    failed = {r: v[0] for r, v in got.items() if v[0] != "ok"}
    if failed:
        raise RuntimeError(f"dryrun_multichip: ranks failed: {failed}")
    losses = {v[1] for v in got.values()}
    losses2 = {v[2] for v in got.values()}
    if len(losses) != 1 or len(losses2) != 1:
        raise AssertionError(f"the ranks' losses differ: {got}")
    line = (f"dryrun_multichip({n_devices}): ok, device={device}, "
            f"mesh=data:{n_devices // 2} "
            f"x model:2, loss={losses.pop():.5f}, sp_render=8x8 ok, "
            f"flagship_loss={losses2.pop():.5f} (tp table-sharded=True), "
            "flagship_tp_render ok")
    print(line)
    return line


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n", type=int, nargs="?", default=4,
                        help="processes (even, at least 4)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="the cards (default) or the CPU")
    args = parser.parse_args()
    dryrun_multichip(args.n, args.device)
