"""Every shipped config file trains one step in the port, from a tiny scene
of its own dataset type on disk: the 20 configs/*_tpu.txt (the block-hash
grid) and the 20 files without _tpu (the parity path: the hash grid, the
hierarchical fine pass) that have no structural priors, and the two
norcliffe_common_room files, which have them (one step with the priors on,
through ``run_nerf``)."""

import os

import numpy as np
import pytest

from _torch_parity import CPU
from _torch_scenes import WRITERS
from indoor_nerf_tpu_torch.train import trainer
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch import run_nerf
from test_torch_config import (
    CONFIGS,
    NERFACTO_CONFIGS,
    PARITY_CONFIGS,
    PRIORS_CONFIGS,
    TPU_CONFIGS,
    _ROOT,
    _dataset_type,
)

# The model cut to test size; 16 rays fit every config's precrop.
TINY = ["--n_levels", "4", "--finest_res", "32", "--log2_hashmap_size", "12",
        "--occ_resolution", "16", "--occ_candidates", "32", "--occ_samples",
        "8", "--N_rand", "16", "--n_iters", "1"] + CPU


@pytest.fixture(scope="module")
def scene_dirs(tmp_path_factory):
    return {kind: WRITERS[kind](tmp_path_factory.mktemp(kind))
            for kind in ("blender", "llff", "scannet")}


# The parity files cut to test size: 4 levels, 8 + 8 samples.
TINY_PARITY = TINY + ["--N_samples", "8", "--N_importance", "8"]


def test_twenty_of_the_twenty_one_tpu_configs_train():
    """The 42 files split into the 20 + 20 without the priors and the two
    with them: every one of the 21 _tpu files trains."""
    assert len([p for p in CONFIGS if p.endswith("_tpu.txt")]) == 21
    assert len(TPU_CONFIGS) == 20
    assert len(CONFIGS) == 42 and len(PARITY_CONFIGS) == 20
    assert sorted(os.path.basename(p) for p in CONFIGS
                  if p not in TPU_CONFIGS + PARITY_CONFIGS) == sorted(PRIORS_CONFIGS)


@pytest.mark.parametrize("path", TPU_CONFIGS)
def test_tpu_config_trains_one_step_from_files(path, scene_dirs, tmp_path):
    argv = ["--config", os.path.join(_ROOT, path), "--datadir",
            scene_dirs[_dataset_type(path)], "--basedir", str(tmp_path)] + TINY
    out = trainer.train(parse_args(argv))
    assert out["state"]["step"] == 1 and np.isfinite(out["losses"][0])
    assert sorted(f for f in os.listdir(out["logdir"])
                  if f.endswith(".ckpt")) == ["000001.ckpt"]


@pytest.mark.parametrize("path", PARITY_CONFIGS)
def test_parity_config_trains_one_step_from_files(path, scene_dirs, tmp_path):
    """The hash grid with the fine pass (N_importance 64 or 128 as shipped,
    cut to 8 here), the parser's NeRFSmall widths."""
    argv = ["--config", os.path.join(_ROOT, path), "--datadir",
            scene_dirs[_dataset_type(path)], "--basedir", str(tmp_path)] \
        + TINY_PARITY
    out = trainer.train(parse_args(argv))
    assert out["state"]["step"] == 1 and np.isfinite(out["losses"][0])
    assert sorted(out["state"]["params"]) == ["coarse", "fine", "table"]
    assert sorted(f for f in os.listdir(out["logdir"])
                  if f.endswith(".ckpt")) == ["000001.ckpt"]


@pytest.mark.parametrize("name", ["norcliffe_common_room_tpu.txt",
                                  "norcliffe_common_room.txt"])
def test_structural_priors_config_is_refused(scene_dirs, tmp_path, name):
    """No longer refused: each norcliffe file trains one step through
    ``run_nerf`` with the priors active from step 0 (the files start them
    at 4000), the normal nets in the params and the file's weights at the
    ramp's first step in the step's diagnostics."""
    path = os.path.join(_ROOT, "configs", name)
    tiny = TINY if name.endswith("_tpu.txt") else TINY_PARITY
    out = run_nerf.main(["--config", path, "--datadir", scene_dirs["blender"],
                         "--basedir", str(tmp_path),
                         "--structural_loss_start_iter", "0"] + tiny)
    state = out["state"]
    assert state["step"] == 1 and np.isfinite(out["losses"][0])
    assert state["params"]["coarse"].predict_normals
    assert out["prior_weights"] == {"depth_prior": 0.0, "planarity": 0.001,
                                    "manhattan": 0.0005,
                                    "normal_consistency": 0.0002}
    assert sorted(f for f in os.listdir(out["logdir"])
                  if f.endswith(".ckpt")) == ["000001.ckpt"]


@pytest.mark.parametrize("path", NERFACTO_CONFIGS)
def test_nerfacto_config_trains_one_step_from_files(path, scene_dirs,
                                                    tmp_path):
    """The nerfacto file trains one step through ``run_nerf`` (its proposal
    chain cut to 16 + 8 samples and 2^10 rows here)."""
    out = run_nerf.main(["--config", os.path.join(_ROOT, path), "--datadir",
                         scene_dirs["blender"], "--basedir", str(tmp_path),
                         "--proposal_samples", "16,8", "--nerf_samples", "8",
                         "--proposal_log2_hashmap_size", "10"] + TINY)
    state = out["state"]
    assert state["step"] == 1 and np.isfinite(out["losses"][0])
    assert sorted(state["params"]) == ["coarse", "embedding_appearance",
                                       "proposal_0", "proposal_1", "table"]
    assert sorted(f for f in os.listdir(out["logdir"])
                  if f.endswith(".ckpt")) == ["000001.ckpt"]
