"""The port's own CLI parser against the JAX package's, and the explicit
device of the port's entry points."""

import argparse
import glob
import os

import pytest
import torch

import indoor_nerf_tpu.train.config as jconfig
import indoor_nerf_tpu_torch
import indoor_nerf_tpu_torch.train.config as tconfig
from _torch_parity import TINY_FLAGSHIP
from indoor_nerf_tpu_torch import serve
from indoor_nerf_tpu_torch.train.trainer import train

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, _ROOT)
                 for p in glob.glob(os.path.join(_ROOT, "configs", "*.txt")))


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parsers_share_every_flag_and_default():
    """``--device`` is the only flag the port adds; every other flag has the
    JAX parser's option strings, type, choices and default."""
    ja, ta = _actions(jconfig.build_parser()), _actions(tconfig.build_parser())
    assert set(ta) - set(ja) == {"device"} and not set(ja) - set(ta)
    for dest, a in ja.items():
        b = ta[dest]
        assert (b.option_strings, b.type, b.choices, b.default, type(b)) == \
            (a.option_strings, a.type, a.choices, a.default, type(a)), dest
    assert ta["device"].default == "cuda"


def test_flagship_preset_is_the_jax_one():
    assert tconfig.FLAGSHIP_PRESET == jconfig.FLAGSHIP_PRESET
    assert tconfig.FLAGSHIP_PRESET is not jconfig.FLAGSHIP_PRESET


def test_the_port_does_not_load_the_jax_file():
    src = open(tconfig.__file__).read()
    assert "importlib" not in src and "exec_module" not in src
    assert "import indoor_nerf_tpu." not in src
    assert os.path.dirname(tconfig.__file__).endswith(
        os.path.join("indoor_nerf_tpu_torch", "train"))
    assert tconfig.build_parser.__module__ == "indoor_nerf_tpu_torch.train.config"


def _same(argv):
    want = vars(jconfig.parse_args(argv))
    got = vars(tconfig.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("path", CONFIGS)
def test_config_file_parses_to_the_jax_values(path, monkeypatch):
    monkeypatch.chdir(_ROOT)
    _same(["--config", path])


@pytest.mark.parametrize("argv", [
    [], ["--flagship"], ["--flagship", "--n_levels", "4", "--block_io", "f32"],
    ["--i_embed", "3", "--use_pallas", "--use_occupancy", "--occ_samples", "32"],
    ["--config", "configs/lego_tpu.txt", "--block_size", "4", "--lrate", "0.01"],
    ["--sparse-loss-weight", "1e-8", "--tv-loss-weight", "0", "--unknown", "x"],
])
def test_command_lines_parse_to_the_jax_values(argv, monkeypatch):
    monkeypatch.chdir(_ROOT)
    if "--unknown" in argv:  # both refuse an unknown flag
        for parse in (jconfig.parse_args, tconfig.parse_args):
            with pytest.raises(SystemExit):
                parse(argv)
        return
    _same(argv)


def test_flagship_inside_a_config_file_sits_below_its_values(tmp_path):
    cfg = tmp_path / "c.txt"
    cfg.write_text("flagship = True\nn_levels = 4  # the file wins\n"
                   "expname = t\n")
    _same(["--config", str(cfg)])
    got = tconfig.parse_args(["--config", str(cfg), "--block_size", "4"])
    assert (got.n_levels, got.feats_per_level, got.block_size, got.block_io) \
        == (4, 4, 4, "bf16")
    bad = tmp_path / "bad.txt"
    bad.write_text("no equals sign\n")
    with pytest.raises(ValueError, match="bad config line"):
        tconfig.parse_args(["--config", str(bad)])


@pytest.mark.parametrize("value", ["cpu", "cuda", "cuda:0", "cuda:1"])
def test_device_flag_parses(value):
    assert tconfig.parse_args(["--device", value]).device == value


def test_resolve_device_never_falls_back(monkeypatch):
    assert indoor_nerf_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        indoor_nerf_tpu_torch.resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device is visible"):
            indoor_nerf_tpu_torch.resolve_device(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert indoor_nerf_tpu_torch.resolve_device("cuda") == torch.device("cuda")
    with pytest.raises(RuntimeError, match="only 1 CUDA device"):
        indoor_nerf_tpu_torch.resolve_device("cuda:1")


@pytest.mark.parametrize("entry", ["train", "serve"])
def test_entry_points_raise_when_the_card_is_absent(entry, monkeypatch):
    """``cuda`` is the default device; with no card visible the trainer and
    the server raise, they do not run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = TINY_FLAGSHIP + ["--N_rand", "64", "--n_iters", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        if entry == "train":
            train(tconfig.parse_args(flags))
        else:
            serve.build(argparse.Namespace(width=8, height=8,
                                           train_args=["--"] + flags))


@pytest.mark.parametrize("device", [None, "cpu"])
def test_profile_step_exits_1_without_a_card(device, monkeypatch, capsys):
    """The step profiler's numbers are the card's: with no card visible, or
    asked for the CPU, it exits 1 and prints no number."""
    from indoor_nerf_tpu_torch import profile_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = TINY_FLAGSHIP + (["--device", device] if device else [])
    assert profile_step.main(["--"] + flags) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no visible CUDA device" in out.err


def test_one_batch_is_the_trainers_first_batch():
    """``one_batch`` gives the config ``train`` builds and the sampler's
    first batch from the seed, on the device asked for."""
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.data.pipeline import BatchedRaySampler
    from indoor_nerf_tpu_torch.train.trainer import build_train_config, one_batch

    args = tconfig.parse_args(TINY_FLAGSHIP + ["--N_rand", "64"])
    cfg, batch = one_batch(args, torch.device("cpu"))
    scene = load_dataset(args)
    H, W, _ = scene.hwf
    assert cfg == build_train_config(args, scene)
    want = BatchedRaySampler(scene.images, scene.poses, scene.i_train, H, W,
                             scene.K, 64, seed=args.seed).next()
    assert set(batch) == {"rays_o", "rays_d", "target"}
    for k, v in batch.items():
        assert v.device.type == "cpu" and v.shape == (64, 3)
        assert torch.equal(v, torch.from_numpy(want[k]))
    _, other = one_batch(args, torch.device("cpu"), seed=args.seed + 1)
    assert not torch.equal(other["rays_o"], batch["rays_o"])


# Every configs/*_tpu.txt file the port trains (all but the one with
# structural priors, Queue 1 item 5); the other files run --i_embed 1, the
# parity path (item 4).
TPU_CONFIGS = [p for p in CONFIGS if p.endswith("_tpu.txt")
               and os.path.basename(p) != "norcliffe_common_room_tpu.txt"]


def _dataset_type(path):
    return tconfig.parse_args(["--config", os.path.join(_ROOT, path)]).dataset_type


@pytest.fixture(scope="module")
def scene_dirs(tmp_path_factory):
    """A tiny scene of each dataset type the configs name."""
    from _torch_scenes import WRITERS

    return {kind: WRITERS[kind](tmp_path_factory.mktemp(kind))
            for kind in ("blender", "llff", "scannet")}


@pytest.mark.parametrize("path", CONFIGS)
def test_config_file_builds_the_jax_train_config(path, scene_dirs):
    """Every config file with ``--datadir`` on a tiny scene of its dataset
    type: the port's ``build_train_config`` builds what the JAX one builds
    for the ``_tpu`` files the port trains, and names the ROADMAP item of
    what it does not run for the others."""
    from indoor_nerf_tpu.data.load import load_dataset as j_load_dataset
    from indoor_nerf_tpu.train.trainer import build_train_config as j_build
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    argv = ["--config", os.path.join(_ROOT, path),
            "--datadir", scene_dirs[_dataset_type(path)]]
    targs = tconfig.parse_args(argv)
    scene = load_dataset(targs)
    if path not in TPU_CONFIGS:
        item = "item 5" if targs.i_embed == 3 else "item 4"
        with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
            build_train_config(targs, scene)
        return
    jargs = jconfig.parse_args(argv)
    want = j_build(jargs, j_load_dataset(jargs))
    got = build_train_config(targs, scene)
    for f in ("near", "far", "ndc_hwf", "n_rand", "lrate", "lrate_decay",
              "sparse_loss_weight", "tv_loss_weight", "tv_cutoff_iter"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("n_samples", "n_importance", "perturb", "lindisp", "white_bkgd",
              "raw_noise_std", "ndc", "n_occ_samples"):
        assert getattr(got.render, f) == getattr(want.render, f), f
    gb, wb = got.render.field.block_grid, want.render.field.block_grid
    for f in ("bbox_min", "bbox_max", "n_levels", "n_features_per_level",
              "log2_rows", "base_resolution", "finest_resolution",
              "gather_dtype", "scatter_dtype", "block_size"):
        assert getattr(gb, f) == getattr(wb, f), f
    go, wo = got.render.occupancy, want.render.occupancy
    for f in ("bbox_min", "bbox_max", "resolution", "weighting"):
        assert getattr(go, f) == getattr(wo, f), f
    assert got.render.ndc == (_dataset_type(path) == "llff")
