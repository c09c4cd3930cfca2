"""The port runs where jax is missing (the card's machine has none)."""

import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROGRAM = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
import indoor_nerf_tpu_torch
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
import indoor_nerf_tpu_torch.ops.group_scatter
import indoor_nerf_tpu_torch.ops.table_scatter
import indoor_nerf_tpu_torch.train.optim
import indoor_nerf_tpu_torch.train.step
from indoor_nerf_tpu_torch.data.pipeline import BatchedRaySampler
from indoor_nerf_tpu_torch.train.trainer import train

train_args = parse_args(["--flagship", "--dataset_type", "synthetic",
                         "--use_viewdirs", "--white_bkgd", "--n_levels", "4",
                         "--finest_res", "32", "--log2_hashmap_size", "12",
                         "--occ_resolution", "16", "--N_rand", "64",
                         "--n_iters", "2", "--i_print", "1"])
result = train(train_args)
assert result["state"]["step"] == 2
assert np.all(np.isfinite(result["losses"]))
leaked = sorted(m for m in sys.modules
                if m == "indoor_nerf_tpu" or m.startswith("indoor_nerf_tpu."))
assert not leaked, leaked
print("NOJAX_OK")
"""


def test_port_renders_without_jax():
    """Serving and two training steps with every `import jax` failing."""
    env = dict(os.environ, PYTHONPATH=_ROOT)
    proc = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=_ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX_OK" in proc.stdout
