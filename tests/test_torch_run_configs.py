"""Every shipped configs/*_tpu.txt but norcliffe_common_room_tpu.txt trains
one step in the port, from a tiny scene of its own dataset type on disk;
that one (structural priors) is refused naming ROADMAP.md Queue 1 item 5."""

import os

import numpy as np
import pytest

from _torch_parity import CPU
from _torch_scenes import WRITERS
from indoor_nerf_tpu_torch.train import trainer
from indoor_nerf_tpu_torch.train.config import parse_args
from test_torch_config import CONFIGS, TPU_CONFIGS, _ROOT, _dataset_type

# The model cut to test size; 16 rays fit every config's precrop.
TINY = ["--n_levels", "4", "--finest_res", "32", "--log2_hashmap_size", "12",
        "--occ_resolution", "16", "--occ_candidates", "32", "--occ_samples",
        "8", "--N_rand", "16", "--n_iters", "1"] + CPU


@pytest.fixture(scope="module")
def scene_dirs(tmp_path_factory):
    return {kind: WRITERS[kind](tmp_path_factory.mktemp(kind))
            for kind in ("blender", "llff", "scannet")}


def test_twenty_of_the_twenty_one_tpu_configs_train():
    assert len([p for p in CONFIGS if p.endswith("_tpu.txt")]) == 21
    assert len(TPU_CONFIGS) == 20


@pytest.mark.parametrize("path", TPU_CONFIGS)
def test_tpu_config_trains_one_step_from_files(path, scene_dirs, tmp_path):
    argv = ["--config", os.path.join(_ROOT, path), "--datadir",
            scene_dirs[_dataset_type(path)], "--basedir", str(tmp_path)] + TINY
    out = trainer.train(parse_args(argv))
    assert out["state"]["step"] == 1 and np.isfinite(out["losses"][0])
    assert sorted(f for f in os.listdir(out["logdir"])
                  if f.endswith(".ckpt")) == ["000001.ckpt"]


def test_structural_priors_config_is_refused(scene_dirs, tmp_path):
    path = os.path.join(_ROOT, "configs", "norcliffe_common_room_tpu.txt")
    args = parse_args(["--config", path, "--datadir", scene_dirs["blender"],
                       "--basedir", str(tmp_path)] + TINY)
    with pytest.raises(NotImplementedError,
                       match="Queue 1 item 5"):
        trainer.train(args)
