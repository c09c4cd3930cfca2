"""The port runs where jax and the JAX package are missing (the card's
machine has no jax, and the port uses nothing of ``indoor_nerf_tpu/``)."""

import os
import shutil
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROGRAM = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["flax"] = None
import numpy as np
import torch
torch.set_num_threads(1)
import os
import indoor_nerf_tpu_torch
assert os.path.realpath(indoor_nerf_tpu_torch.__file__).startswith(
    os.path.realpath(os.getcwd())), indoor_nerf_tpu_torch.__file__
assert not os.path.exists("indoor_nerf_tpu")
from indoor_nerf_tpu_torch.data.load import load_dataset
from indoor_nerf_tpu_torch.models.field import init_field_params
from indoor_nerf_tpu_torch.ops.occupancy import init_occupancy
from indoor_nerf_tpu_torch.render.renderer import render_image
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.train.trainer import build_train_config

args = parse_args(["--flagship", "--dataset_type", "synthetic",
                   "--use_viewdirs", "--white_bkgd", "--n_levels", "4",
                   "--finest_res", "32", "--log2_hashmap_size", "12",
                   "--occ_resolution", "16"])
scene = load_dataset(args)
cfg = build_train_config(args, scene)
params = init_field_params(torch.Generator().manual_seed(0), cfg.render.field)
out = render_image(params, 8, 8, scene.K, scene.poses[0], scene.near,
                   scene.far, cfg.render,
                   occ_state=init_occupancy(cfg.render.occupancy))
assert out["rgb_map"].shape == (8, 8, 3)
assert np.all(np.isfinite(out["rgb_map"]))
assert np.all(np.isfinite(out["depth_map"]))

# Two training steps on the CPU, and the modules of the training slice.
import indoor_nerf_tpu_torch.bench
import indoor_nerf_tpu_torch.path_streams
import indoor_nerf_tpu_torch.ops.group_scatter
import indoor_nerf_tpu_torch.ops.lane_gather
import indoor_nerf_tpu_torch.ops.table_scatter
import indoor_nerf_tpu_torch.ops.tile_interp
import indoor_nerf_tpu_torch.train.optim
import indoor_nerf_tpu_torch.train.step
from indoor_nerf_tpu_torch.data.pipeline import BatchedRaySampler
from indoor_nerf_tpu_torch.train.trainer import train

train_args = parse_args(["--flagship", "--dataset_type", "synthetic",
                         "--use_viewdirs", "--white_bkgd", "--n_levels", "4",
                         "--finest_res", "32", "--log2_hashmap_size", "12",
                         "--occ_resolution", "16", "--N_rand", "64",
                         "--n_iters", "2", "--i_print", "1",
                         "--device", "cpu"])
result = train(train_args)
assert result["state"]["step"] == 2
assert np.all(np.isfinite(result["losses"]))

# One step on the tile-interp route (--use_pallas at the block-hash defaults).
tile_args = parse_args(["--i_embed", "3", "--use_pallas", "--use_occupancy",
                        "--N_importance", "0", "--occ_samples", "8",
                        "--occ_weighting", "transmittance", "--dataset_type",
                        "synthetic", "--use_viewdirs", "--white_bkgd",
                        "--n_levels", "4", "--finest_res", "32",
                        "--log2_hashmap_size", "14", "--occ_resolution", "16",
                        "--occ_candidates", "32", "--N_rand", "64",
                        "--n_iters", "1", "--i_print", "1", "--device", "cpu"])
result = train(tile_args)
assert result["state"]["step"] == 1
assert np.all(np.isfinite(result["losses"]))
picked = indoor_nerf_tpu_torch.ops.lane_select(
    torch.arange(256, dtype=torch.float32).reshape(2, 128),
    torch.tensor([[5, 5], [0, 127]], dtype=torch.int32))
assert picked.tolist() == [[5.0, 5.0], [128.0, 255.0]]

# Checkpoints and baked serving: train with a run directory, resume, serve
# the checkpoint online and baked, and import a checkpoint that the JAX
# package wrote (its path comes from the test) with flax out of reach.
import argparse
import indoor_nerf_tpu_torch.bridge
import indoor_nerf_tpu_torch.render.baked
import indoor_nerf_tpu_torch.utils.checkpoint
from indoor_nerf_tpu_torch import serve
from indoor_nerf_tpu_torch.train.step import init_train_state
from indoor_nerf_tpu_torch.utils.checkpoint import restore_checkpoint

run = ["--flagship", "--dataset_type", "synthetic", "--use_viewdirs",
       "--white_bkgd", "--n_levels", "4", "--finest_res", "32",
       "--log2_hashmap_size", "12", "--occ_resolution", "16", "--N_rand", "64",
       "--i_print", "1", "--device", "cpu", "--expname", "nojax",
       "--basedir", "runs"]
train(parse_args(run + ["--n_iters", "2"]))
result = train(parse_args(run + ["--n_iters", "3"]))
assert result["state"]["step"] == 3 and len(result["losses"]) == 1
assert sorted(f for f in os.listdir(result["logdir"])
              if f.endswith(".ckpt")) == ["000002.ckpt", "000003.ckpt"]
for extra in ({}, {"baked": True, "baked_res": 8, "snapshot": "runs/snap.pt",
                   "guided": 2}):
    render, step, hw = serve.build(argparse.Namespace(
        width=8, height=8, train_args=["--"] + run, **extra))
    maps, _ = render(scene.poses[0])
    assert step == 3 and np.all(np.isfinite(maps["rgb_map"]))
assert os.path.exists("runs/snap.pt")
imported = restore_checkpoint(
    os.environ["NOJAX_JAX_CHECKPOINT"],
    init_train_state(torch.Generator().manual_seed(0),
                     build_train_config(parse_args(run), scene)))
assert imported["step"] == 2
# The file loaders, NDC, the training loop's evaluation and render-only.
import indoor_nerf_tpu_torch.data.bbox
import indoor_nerf_tpu_torch.data.blender
import indoor_nerf_tpu_torch.data.deepvoxels
import indoor_nerf_tpu_torch.data.images
import indoor_nerf_tpu_torch.data.linemod
import indoor_nerf_tpu_torch.data.llff
import indoor_nerf_tpu_torch.data.scannet
import indoor_nerf_tpu_torch.render.path
import indoor_nerf_tpu_torch.run_nerf
import indoor_nerf_tpu_torch.utils.evaluation
import indoor_nerf_tpu_torch.utils.metrics
from indoor_nerf_tpu_torch.data.scene_files import (
    make_plane_scene, make_sphere_scene, write_blender_scene, write_llff_scene)

write_blender_scene("blender", make_sphere_scene(8, 24, 24))
write_llff_scene("llff", make_plane_scene(16), 96, 128, 120.0, 8)
files = ["--flagship", "--use_viewdirs", "--n_levels", "4", "--finest_res",
         "32", "--log2_hashmap_size", "12", "--occ_resolution", "16",
         "--N_rand", "16", "--device", "cpu", "--basedir", "runs"]
blender = files + ["--dataset_type", "blender", "--datadir", "blender",
                   "--half_res", "--white_bkgd", "--no_batching",
                   "--precrop_iters", "1", "--testskip", "1", "--expname",
                   "files", "--n_iters", "2", "--i_testset", "2"]
result = train(parse_args(blender))
assert [t["step"] for t in result["testsets"]] == [2]
shown = train(parse_args(blender + ["--render_only", "--render_test"]))
assert shown["step"] == 2 and len(shown["psnrs"]) == 4
result = train(parse_args(files + ["--dataset_type", "llff", "--datadir",
                                   "llff", "--n_iters", "1"]))
assert result["state"]["step"] == 1 and np.isfinite(result["losses"][0])
# The parity path: a hash-grid field with the fine pass and a PE field
# with the classic NeRF built and rendered, one step each, and the first
# trained from files through configs/lego.txt's flags.
import indoor_nerf_tpu_torch.ops.hashing
import indoor_nerf_tpu_torch.ops.tv
for extra in ([], ["--i_embed", "0", "--i_embed_views", "0", "--netdepth",
                   "2", "--netwidth", "16", "--netdepth_fine", "2",
                   "--netwidth_fine", "16"]):
    parity = parse_args(["--dataset_type", "synthetic", "--use_viewdirs",
                         "--white_bkgd", "--n_levels", "4", "--finest_res",
                         "32", "--log2_hashmap_size", "12", "--N_samples",
                         "8", "--N_importance", "8", "--N_rand", "16",
                         "--n_iters", "1", "--device", "cpu"] + extra)
    pcfg = build_train_config(parity, scene)
    pparams = init_field_params(torch.Generator().manual_seed(0),
                                pcfg.render.field)
    assert sorted(pparams) == (["coarse", "fine", "table"] if not extra
                               else ["coarse", "fine"])
    out = render_image(pparams, 8, 8, scene.K, scene.poses[0], scene.near,
                       scene.far, pcfg.render)
    assert out["rgb_map"].shape == (8, 8, 3)
    assert np.all(np.isfinite(out["rgb_map"]))
    result = train(parity)
    assert result["state"]["step"] == 1 and np.isfinite(result["losses"][0])
lego = ["--config", "configs/lego.txt", "--datadir", "blender", "--basedir",
        "runs", "--n_levels", "4", "--finest_res", "32", "--log2_hashmap_size",
        "12", "--N_samples", "8", "--N_importance", "8", "--N_rand", "16",
        "--precrop_iters", "1", "--testskip", "1", "--n_iters", "1",
        "--i_testset", "1", "--device", "cpu"]
result = train(parse_args(lego))
assert result["state"]["step"] == 1 and len(result["testsets"]) == 1
# The structural priors and the step's extensions: the room scene in
# blender layout, configs/norcliffe_common_room_tpu.txt for two steps with
# the priors from step 0, and a flagship step with every extension on.
import indoor_nerf_tpu_torch.losses.distortion
import indoor_nerf_tpu_torch.losses.priors
from indoor_nerf_tpu_torch.data.scene_files import make_room_blender_scene

write_blender_scene("room", make_room_blender_scene(8, 16, 16))
room = ["--config", "configs/norcliffe_common_room_tpu.txt", "--datadir",
        "room", "--basedir", "runs", "--n_levels", "4", "--finest_res", "32",
        "--log2_hashmap_size", "12", "--occ_resolution", "16",
        "--occ_candidates", "32", "--occ_samples", "8", "--N_rand", "16",
        "--precrop_iters", "0", "--n_iters", "2", "--i_print", "1",
        "--structural_loss_start_iter", "0", "--device", "cpu"]
result = train(parse_args(room))
assert result["state"]["step"] == 2 and np.all(np.isfinite(result["losses"]))
assert result["state"]["params"]["coarse"].predict_normals
extensions = parse_args([
    "--flagship", "--dataset_type", "synthetic", "--use_viewdirs",
    "--white_bkgd", "--n_levels", "4", "--finest_res", "32",
    "--log2_hashmap_size", "12", "--occ_resolution", "16", "--N_rand", "16",
    "--n_iters", "1", "--device", "cpu", "--distortion_loss_weight", "0.01",
    "--table_decay_weight", "0.01", "--ema_decay", "0.9",
    "--freq_anneal_iters", "4", "--view_anneal_iters", "4"])
result = train(extensions)
assert result["state"]["ema"] is not None and np.isfinite(result["losses"][0])
leaked = sorted(m for m in sys.modules
                if m == "indoor_nerf_tpu" or m.startswith("indoor_nerf_tpu.")
                or m == "flax" and sys.modules[m] is not None)
assert not leaked, leaked
print("NOJAX_OK")
"""


def test_port_renders_without_jax(tmp_path):
    """Serving and training steps with every `import jax` failing, from a
    copy of the tree that holds the port's package and the config files,
    and no ``indoor_nerf_tpu/`` directory; the parity path among them."""
    shutil.copytree(os.path.join(_ROOT, "indoor_nerf_tpu_torch"),
                    tmp_path / "indoor_nerf_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copytree(os.path.join(_ROOT, "configs"), tmp_path / "configs")
    assert not (tmp_path / "indoor_nerf_tpu").exists()
    from test_torch_checkpoint import jax_checkpoint

    path, _, _ = jax_checkpoint(tmp_path, steps=2)
    env = dict(os.environ, PYTHONPATH=str(tmp_path), NOJAX_JAX_CHECKPOINT=path)
    proc = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX_OK" in proc.stdout
