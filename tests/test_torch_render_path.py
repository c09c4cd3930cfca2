"""render_path and write_video of the port against the JAX package's."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY_FLAGSHIP, both_states, configs
from indoor_nerf_tpu.render.path import render_path as j_render_path
from indoor_nerf_tpu_torch.render.path import render_path, write_video
from indoor_nerf_tpu_torch.utils.png import read_png


def _states(jcfg):
    """Both packages' states on the JAX initial weights, a table of N(0,
    0.1) entries and a random occupancy grid."""
    rng = np.random.default_rng(0)
    jstate, tstate = both_states(jcfg, occ_rng=rng)
    table = (0.1 * rng.standard_normal(jstate["params"]["table"].shape)
             ).astype(np.float32)
    jstate["params"]["table"] = jnp.asarray(table)
    tstate["params"]["table"] = torch.from_numpy(table)
    return jstate, tstate


def test_render_path_matches_jax(tmp_path):
    """Five held-out-like poses in blocks of 4 (a partial last block): rgb
    within 1e-4, PSNRs within 1e-3 dB, the same pickle name; one figure
    (rgb beside grey depth) per view."""
    jcfg, tcfg, scene = configs(TINY_FLAGSHIP + ["--synthetic_res", "24"])
    jstate, tstate = _states(jcfg)
    poses = scene.poses[:5]
    gt = scene.images[:5]
    os.makedirs(tmp_path / "t")
    os.makedirs(tmp_path / "j")
    got = render_path(poses, scene.hwf, scene.K, tcfg.render.test_mode(),
                      tstate["params"], scene.near, scene.far, gt_imgs=gt,
                      savedir=str(tmp_path / "t"), occ_state=tstate["occ"],
                      tile_rays=256)
    want = j_render_path(poses, scene.hwf, scene.K, jcfg.render.test_mode(),
                         jstate["params"], scene.near, scene.far, gt_imgs=gt,
                         savedir=str(tmp_path / "j"), occ_state=jstate["occ"],
                         tile_rays=256)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-3)
    names = sorted(os.listdir(tmp_path / "t"))
    pkl = [n for n in os.listdir(tmp_path / "j") if n.endswith(".pkl")]
    assert names == [f"{i:03d}.png" for i in range(5)] + pkl
    fig = read_png(str(tmp_path / "t" / "000.png"))
    assert fig.shape == (24, 48, 3)
    assert np.all(fig[:, 24:, 0] == fig[:, 24:, 1])  # grey depth


def test_render_path_render_factor(tmp_path):
    """At --render_factor 2 the views are half size and, as in JAX, no PSNR
    is computed."""
    jcfg, tcfg, scene = configs(TINY_FLAGSHIP + ["--synthetic_res", "24"])
    _, tstate = _states(jcfg)
    rgbs, depths, psnrs = render_path(
        scene.poses[:2], scene.hwf, scene.K, tcfg.render.test_mode(),
        tstate["params"], scene.near, scene.far, gt_imgs=scene.images[:2],
        savedir=str(tmp_path), render_factor=2, occ_state=tstate["occ"])
    assert rgbs.shape == (2, 12, 12, 3) and depths.shape == (2, 12, 12)
    assert psnrs == [] and sorted(os.listdir(tmp_path)) == ["000.png", "001.png"]


def test_write_video_without_imageio_writes_frames(tmp_path, monkeypatch, capsys):
    frames = np.random.default_rng(1).random((3, 8, 10, 3))
    monkeypatch.setitem(sys.modules, "imageio", None)
    out = write_video(str(tmp_path / "v_rgb.mp4"), frames)
    assert out == str(tmp_path / "v_rgb_frames")
    assert sorted(os.listdir(out)) == ["000.png", "001.png", "002.png"]
    np.testing.assert_array_equal(read_png(os.path.join(out, "002.png")),
                                  (255 * frames[2]).astype(np.uint8))
    assert "imageio is not installed" in capsys.readouterr().out
    disp = write_video(str(tmp_path / "v_disp.mp4"), frames[..., 0])
    assert read_png(os.path.join(disp, "000.png")).shape == (8, 10)


def test_write_video_with_imageio(tmp_path):
    pytest.importorskip("imageio")
    out = write_video(str(tmp_path / "v.mp4"),
                      np.zeros((2, 8, 8, 3), np.float32))
    assert os.path.exists(out) and out.endswith((".mp4", ".gif"))
