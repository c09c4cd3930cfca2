"""The training loop of the port (``train/trainer.py::train``) through its
CLI, ``python -m indoor_nerf_tpu_torch.run_nerf``, on the CPU: a run from
files with held-out evaluations, checkpoints and a video writes the JAX
trainer's artifacts; ``--render_only --render_test`` reproduces the last
held-out PSNR; resumes, ``--profile_dir`` and ``--debug_nans``."""

import contextlib
import io
import json
import os
import pickle

import numpy as np
import pytest
import torch

from _torch_parity import CPU, TINY_FLAGSHIP
from _torch_scenes import write_blender
from indoor_nerf_tpu_torch import run_nerf
from indoor_nerf_tpu_torch.train import trainer
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.train.optim import named_leaves

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEGO = os.path.join(_ROOT, "configs", "lego_tpu.txt")
# configs/lego_tpu.txt at test size: the model cut down, the precrop (6x6
# of the 12x12 half-resolution views) for 3 steps.
TINY = ["--n_levels", "4", "--finest_res", "32", "--log2_hashmap_size", "12",
        "--occ_resolution", "16", "--occ_candidates", "32", "--occ_samples",
        "8", "--N_rand", "16", "--precrop_iters", "3", "--lrate", "0.01",
        "--testskip", "4"] + CPU


@pytest.fixture(scope="module")
def lego_run(tmp_path_factory):
    """``run_nerf --config configs/lego_tpu.txt`` for 6 steps from a
    24-view blender scene: test sets and checkpoints every 3 steps, the
    video at 6. Returns (flags, logdir, printed text)."""
    root = tmp_path_factory.mktemp("lego")
    flags = ["--config", LEGO, "--datadir", write_blender(root / "scene"),
             "--basedir", str(root / "logs")] + TINY
    run = flags + ["--n_iters", "6", "--i_print", "2", "--i_weights", "3",
                   "--i_testset", "3", "--i_video", "6"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run_nerf.main is trainer.main
        trainer.main(run)
    return flags, trainer.logdir_of(parse_args(run)), buf.getvalue()


def _test_psnr(d):
    (name,) = [n for n in os.listdir(d) if n.startswith("test_psnrs_avg")]
    with open(os.path.join(d, name), "rb") as f:
        return name, pickle.load(f)


def test_run_writes_the_jax_trainers_artifacts(lego_run):
    """The files of JAX trainer.py for the same flags (the figures aside:
    PNGs here, matplotlib figures there)."""
    flags, logdir, text = lego_run
    files = set(os.listdir(logdir))
    expname = os.path.basename(logdir)
    videos = {n for n in files if n.startswith(f"{expname}_spiral_000006_")}
    assert {n.split("_")[-1].split(".")[0] for n in videos} >= {"rgb", "disp"}
    assert files - videos == {
        "args.txt", "config.txt", "training_metrics.pkl", "loss_vs_time.pkl",
        "metrics", "testset_000003", "testset_000006", "best.ckpt",
        "000003.ckpt", "000006.ckpt"}
    with open(os.path.join(logdir, "config.txt")) as f, open(LEGO) as g:
        assert f.read() == g.read()
    with open(os.path.join(logdir, "args.txt")) as f:
        args_txt = f.read()
    assert f"expname = {expname}\n" in args_txt and "no_batching = True\n" in args_txt
    metrics = set(os.listdir(os.path.join(logdir, "metrics")))
    assert metrics >= {"config.json", "metrics_iter_3.pkl", "metrics_iter_6.pkl",
                       "main_metrics_3.csv", "main_metrics_6.csv",
                       "summary_table.csv"}
    for step in (3, 6):
        d = os.path.join(logdir, f"testset_{step:06d}")
        name, psnrs = _test_psnr(d)
        assert sorted(os.listdir(d)) == ["000.png", "001.png", "002.png", name]
        assert len(psnrs) == 3 and np.all(np.isfinite(psnrs))
    with open(os.path.join(logdir, "training_metrics.pkl"), "rb") as f:
        td = pickle.load(f)
    assert len(td["losses"]) == 3 and set(td["time_metrics"]) >= {
        "milestones", "iterations_per_second", "baseline_comparison"}
    with open(os.path.join(logdir, "metrics", "metrics_iter_6.pkl"), "rb") as f:
        logged = pickle.load(f)["metrics"]
    assert logged["iteration"] == [1, 2, 3, 4, 5, 6]
    assert [s for s, _ in logged["test_psnr"]] == [3, 6]
    assert [s for s, _ in logged["test_lpips_proxy"]] == [3, 6]
    assert "[best] new best held-out" in text
    assert "=== Training Summary ===" in text
    with open(os.path.join(logdir, "metrics", "config.json")) as f:
        assert json.load(f)["expname"] == expname


def test_render_only_reproduces_the_last_test_psnr(lego_run):
    flags, logdir, _ = lego_run
    out = trainer.train(parse_args(flags + ["--render_only", "--render_test"]))
    assert out["step"] == 6
    d = os.path.join(logdir, "renderonly_test_000006")
    assert out["savedir"] == d
    name, psnrs = _test_psnr(d)
    want_name, want = _test_psnr(os.path.join(logdir, "testset_000006"))
    assert name == want_name
    np.testing.assert_allclose(psnrs, want, rtol=0, atol=1e-6)
    assert out["video"] is not None and os.path.exists(out["video"])


def test_render_only_baked_and_without_a_checkpoint(lego_run, tmp_path, capsys):
    flags, _, _ = lego_run
    out = trainer.train(parse_args(flags + [
        "--render_only", "--render_baked", "--render_baked_res", "8",
        "--render_guided", "0", "--render_factor", "2"]))
    assert out["psnrs"] == [] and out["savedir"].endswith("renderonly_path_000006")
    fresh = trainer.train(parse_args(flags + [
        "--render_only", "--render_test", "--basedir", str(tmp_path)]))
    assert fresh["step"] == 0
    assert "render_only found NO checkpoint" in capsys.readouterr().out


def test_render_fit_appearance_is_refused():
    args = parse_args(TINY_FLAGSHIP + CPU + ["--render_only", "--render_test",
                                             "--render_fit_appearance"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        trainer.train(args)


SYNTH = TINY_FLAGSHIP + CPU + ["--N_rand", "32", "--no_batching",
                               "--precrop_iters", "4", "--i_print", "100"]


def test_resumed_no_batching_run_equals_the_uninterrupted_one(tmp_path):
    """The image sampler is replayed with the steps' own indices (across the
    precrop boundary at 4), so losses and every leaf agree bit for bit."""
    def run(name, n):
        return trainer.train(parse_args(SYNTH + [
            "--expname", name, "--basedir", str(tmp_path), "--n_iters", str(n)]))

    whole = run("whole", 9)
    run("cut", 3)
    rest = run("cut", 9)
    assert rest["losses"] == whole["losses"][3:]
    got, want = (named_leaves(r["state"]["params"]) for r in (rest, whole))
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_profile_dir_writes_a_trace(tmp_path, capsys):
    trainer.train(parse_args(SYNTH + ["--n_iters", "11", "--profile_dir",
                                      str(tmp_path / "prof")]))
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert "[profile] steps 10-11 traced" in capsys.readouterr().out


def test_debug_nans_raises_at_the_first_non_finite_output(monkeypatch):
    real = trainer.train_step
    seen = []

    def poisoned(state, batch, cfg, gen, **kw):
        seen.append(torch.is_anomaly_enabled())
        state, metrics = real(state, batch, cfg, gen, **kw)
        if state["step"] == 2:
            with torch.no_grad():
                named_leaves(state["params"])["coarse.color_net.0.w"][0, 0] = \
                    float("nan")
        return state, metrics

    monkeypatch.setattr(trainer, "train_step", poisoned)
    args = parse_args(SYNTH + ["--n_iters", "4", "--debug_nans"])
    with pytest.raises(FloatingPointError,
                       match="non-finite params.coarse.color_net.0.w after "
                             "iteration 2"):
        trainer.train(args)
    assert seen == [True, True] and not torch.is_anomaly_enabled()


def test_watchdog_saves_before_raising_between_prints(tmp_path, monkeypatch):
    """Each step's loss is read one step late, as JAX reads it: a NaN at
    step 3, between prints, is found once step 4 is queued, and the state
    saved is step 4's, under its own step."""
    real = trainer.train_step

    def poisoned(state, batch, cfg, gen, **kw):
        state, metrics = real(state, batch, cfg, gen, **kw)
        if state["step"] == 3:
            metrics["loss"] = torch.tensor(float("nan"))
        return state, metrics

    monkeypatch.setattr(trainer, "train_step", poisoned)
    args = parse_args(SYNTH + ["--n_iters", "8", "--expname", "nan",
                               "--basedir", str(tmp_path)])
    with pytest.raises(FloatingPointError, match="iteration 3; state of step "
                       "4 saved to .*000004.ckpt"):
        trainer.train(args)
    assert sorted(f for f in os.listdir(trainer.logdir_of(args))
                  if f.endswith(".ckpt")) == ["000004.ckpt"]
