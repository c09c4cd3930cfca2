"""The port's render server, in process on the CPU, plus its config
plumbing and the numpy-only copies it serves from."""

import argparse
import dataclasses
import io
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from _torch_parity import CPU, TINY_FLAGSHIP, configs
from indoor_nerf_tpu.data.poses import pose_spherical as j_pose_spherical
from indoor_nerf_tpu.data.synthetic import (
    make_room_scene as j_make_room_scene,
    make_synthetic_scene as j_make_synthetic_scene,
)
from indoor_nerf_tpu.train.config import FLAGSHIP_PRESET as J_FLAGSHIP_PRESET
from indoor_nerf_tpu_torch import serve
from indoor_nerf_tpu_torch.data.poses import pose_spherical
from indoor_nerf_tpu_torch.data.synthetic import make_room_scene, make_synthetic_scene
from indoor_nerf_tpu_torch.train.config import FLAGSHIP_PRESET, parse_args
from indoor_nerf_tpu_torch.utils.png import decode_png, encode_png

torch.set_num_threads(1)


def test_synthetic_scene_copies_are_identical():
    for ours, theirs, kw in [
        (make_synthetic_scene, j_make_synthetic_scene, dict(n_views=4, H=12, W=12)),
        (make_room_scene, j_make_room_scene,
         dict(n_views=4, H=12, W=12, exposure_jitter=0.2)),
    ]:
        a, b = ours(**kw), theirs(**kw)
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], tuple) and isinstance(a[k][0], np.ndarray):
                for x, y in zip(a[k], b[k]):
                    np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_pose_spherical_copy_is_identical():
    for args in [(0.0, -30.0, 4.0), (123.0, 10.0, 2.5)]:
        np.testing.assert_array_equal(pose_spherical(*args),
                                      j_pose_spherical(*args))


def test_config_is_the_shared_parser_and_preset():
    assert FLAGSHIP_PRESET == J_FLAGSHIP_PRESET
    args = parse_args(["--flagship"])
    assert (args.i_embed, args.block_size, args.block_io, args.n_levels) == \
        (3, 3, "bf16", 8)


def test_build_train_config_matches_jax():
    jcfg, tcfg, _ = configs()
    jb, tb = jcfg.render.field.block_grid, tcfg.render.field.block_grid
    for f in ("bbox_min", "bbox_max", "n_levels", "n_features_per_level",
              "log2_rows", "base_resolution", "finest_resolution",
              "gather_dtype", "scatter_dtype", "block_size"):
        assert getattr(tb, f) == getattr(jb, f), f
    for f in ("resolution", "n_candidates", "weighting", "occlusion_mix",
              "warmup_steps", "floor"):
        assert getattr(tcfg.render.occupancy, f) == \
            getattr(jcfg.render.occupancy, f), f
    for f in ("n_samples", "n_importance", "white_bkgd", "n_occ_samples"):
        assert getattr(tcfg.render, f) == getattr(jcfg.render, f), f
    assert (tcfg.near, tcfg.far) == (jcfg.near, jcfg.far)
    # The full-size flagship geometry: [65536, 256] table.
    _, full, _ = configs(["--flagship", "--dataset_type", "synthetic"])
    fb = full.render.field.block_grid
    assert (fb.n_levels * fb.rows_per_level,
            fb.n_features_per_level * fb.lanes_per_feature) == (65536, 256)


def test_unported_flags_name_the_roadmap_item():
    """The parser's defaults (the hash grid, ``--i_embed 1``) and PE
    (``--i_embed 0``) build the JAX config field for field since the
    parity path came (Queue 1 item 4), A-CAQ's flags its quantizer config
    (item 5b), and the reg patches' and appearance latents' flags their
    fields (item 5c)."""
    for flags in (["--dataset_type", "synthetic"],
                  ["--dataset_type", "synthetic", "--i_embed", "0",
                   "--i_embed_views", "0", "--N_importance", "64"]):
        jcfg, tcfg, _ = configs(flags)
        jf, tf = jcfg.render.field, tcfg.render.field
        for f in ("i_embed", "i_embed_views", "multires", "multires_views",
                  "netdepth", "netwidth", "netdepth_fine", "netwidth_fine",
                  "input_ch", "input_ch_views", "n_importance"):
            assert getattr(tf, f) == getattr(jf, f), f
        if jf.grid is None:
            assert tf.grid is None
        else:
            assert dataclasses.asdict(tf.grid) == dataclasses.asdict(jf.grid)
    jcfg, tcfg, _ = configs(TINY_FLAGSHIP + [
        "--use_quantization", "--use_acaq", "--quantization_bits", "6",
        "--bit_penalty", "0.01", "--target_metric", "0.02",
        "--acaq_start_iter", "40", "--block_io", "int8"])
    jf, tf = jcfg.render.field, tcfg.render.field
    assert tf.use_quantization and jf.use_quantization
    assert dataclasses.asdict(tf.quant) == dataclasses.asdict(jf.quant)
    assert (tcfg.use_acaq, tcfg.acaq_start_iter, tcfg.acaq_interval) == (
        jcfg.use_acaq, jcfg.acaq_start_iter, jcfg.acaq_interval)
    assert dataclasses.asdict(tf.block_grid) == {
        **dataclasses.asdict(jf.block_grid), "tile_interp": False}
    # The reg patches and appearance latents (item 5c) build JAX's fields.
    jcfg, tcfg, _ = configs(TINY_FLAGSHIP + [
        "--use_appearance", "--reg_views", "3", "--reg_patch_size", "6",
        "--reg_mode", "planar", "--reg_start_iter", "20",
        "--reg_depth_tv_weight", "0.3"])
    assert tcfg.render.field.n_appearance == jcfg.render.field.n_appearance > 0
    for f in ("reg_patch_size", "reg_depth_tv_weight", "reg_mode",
              "reg_start_iter"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    with pytest.raises(ValueError, match="JAX package fails on the pair"):
        configs(["--dataset_type", "synthetic", "--i_embed", "0",
                 "--use_quantization"])


def test_serve_appearance_field(tmp_path):
    """A field trained with ``--use_appearance`` is served with the zero
    latent, as the JAX server serves it: its checkpoint's appearance leaf
    is restored, and the online and the ``--baked`` renders equal those of
    the same params without the leaf, bit for bit."""
    from indoor_nerf_tpu_torch.models.field import serving_params
    from indoor_nerf_tpu_torch.render.baked import (
        bake_field,
        make_baked_image_renderer,
    )
    from indoor_nerf_tpu_torch.render.renderer import make_image_renderer
    from indoor_nerf_tpu_torch.train import trainer

    flags = TINY_FLAGSHIP + CPU + ["--use_appearance", "--expname", "app",
                                   "--basedir", str(tmp_path), "--N_rand",
                                   "32", "--lrate", "0.01", "--i_print", "100"]
    out = trainer.train(parse_args(flags + ["--n_iters", "7"]))
    state = out["state"]
    assert state["params"]["appearance"].abs().max() > 0
    params = {k: v for k, v in state["params"].items() if k != "appearance"}
    cfg = configs(TINY_FLAGSHIP + ["--use_appearance"])[1]
    scene = configs(TINY_FLAGSHIP)[2]
    H, W = 10, 12
    focal = scene.hwf[2] * (W / scene.hwf[1])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    c2w = scene.poses[scene.i_test[0]][:3, :4]
    render, step, _ = _build([], flags)
    assert step == 7
    online = make_image_renderer(cfg.render.test_mode(), H, W)(
        serving_params(params, cfg.render.field), c2w, K, scene.near,
        scene.far, state["occ"])
    np.testing.assert_array_equal(render(c2w)[0]["rgb_map"],
                                  online["rgb_map"].numpy())
    render, _, _ = _build(["--baked", "--baked_res", "8"], flags)
    baked = bake_field(serving_params(params, cfg.render.field),
                       cfg.render.field, resolution=8,
                       train_cameras=serve.train_cameras(scene))
    want = make_baked_image_renderer(
        baked, H, W, n_samples=128, n_coarse=64,
        white_bkgd=cfg.render.white_bkgd)(c2w, K, scene.near, scene.far)
    np.testing.assert_array_equal(render(c2w)[0]["rgb_map"],
                                  want["rgb_map"].numpy())


def test_occupancy_with_importance_is_refused():
    """The JAX package fails on the pair (its step reads ``out["rgb0"]``,
    which the occupancy branch never returns); the port says so."""
    with pytest.raises(ValueError, match="JAX package fails on the pair"):
        configs(TINY_FLAGSHIP + ["--N_importance", "8"])[1]


def _build(server_flags, train_flags=TINY_FLAGSHIP + CPU):
    return serve.build(serve.parse_server_args(
        ["--width", "12", "--height", "10"] + server_flags + ["--"] + train_flags))


@pytest.fixture
def baked_calls(monkeypatch):
    """What ``serve.build`` bakes and how it builds the baked renderer."""
    calls = {}
    real_bake, real_make = serve.bake_field, serve.make_baked_image_renderer

    def bake(params, field_cfg, **kw):
        calls["bake"] = kw
        return real_bake(params, field_cfg, **kw)

    def make(baked, H, W, **kw):
        calls["baked"], calls["make"] = baked, kw
        return real_make(baked, H, W, **kw)

    monkeypatch.setattr(serve, "bake_field", bake)
    monkeypatch.setattr(serve, "make_baked_image_renderer", make)
    return calls


BAKED8 = ["--baked", "--baked_res", "8"]


@pytest.mark.parametrize("flags,check", [
    ([], lambda c: c == {}),  # online: nothing is baked
    (BAKED8, lambda c: (
        c["baked"]["config"].resolution, c["baked"]["config"].geo_res,
        c["baked"]["config"].table_dtype, c["bake"]["train_cameras"]["poses"].shape,
        c["make"]["n_samples"], c["make"]["guided"], c["make"]["n_coarse"])
        == (8, 4, "bfloat16", (9, 3, 4), 128, 0, 64)),
    (["--baked", "--baked_res", "16"], lambda c: (
        c["baked"]["config"].resolution,
        tuple(c["baked"]["sigma_table"].shape)) == (16, (64, 128))),
    (BAKED8 + ["--baked_geo_res", "0"], lambda c: (
        c["baked"]["config"].geo_res,
        tuple(c["baked"]["voxel_geo"].shape)) == (8, (512, 128))),
    (BAKED8 + ["--baked_dtype", "int8"], lambda c: (
        c["baked"]["sigma_table"].dtype, c["baked"]["voxel_geo"].dtype)
        == (torch.int8, torch.int8)),
    (BAKED8 + ["--guided", "4"], lambda c: (
        c["make"]["n_samples"], c["make"]["guided"], c["make"]["n_coarse"])
        == (16, 4, 64)),
], ids=["online", "baked", "baked_res", "baked_geo_res", "baked_dtype", "guided"])
def test_serve_baked_flags_take_effect(flags, check, baked_calls):
    """Each baked-serving flag of the JAX server changes what is baked or
    how it is rendered; the render returns the online branch's maps."""
    render, step, hw = _build(flags)
    assert check(baked_calls), baked_calls
    maps, _ = render(pose_spherical(30.0, -30.0, 4.0))
    assert sorted(maps) == ["acc_map", "depth_map", "disp_map", "rgb_map"]
    assert maps["rgb_map"].shape == (10, 12, 3)
    assert all(np.all(np.isfinite(v)) for v in maps.values())


def test_serve_snapshot_is_saved_then_loaded(tmp_path, baked_calls, capsys):
    snap = str(tmp_path / "snaps" / "baked.pt")
    first, _, _ = _build(BAKED8 + ["--snapshot", snap])
    assert os.path.exists(snap) and "bake" in baked_calls
    assert f"saved snapshot to {snap}" in capsys.readouterr().out
    baked_calls.clear()
    second, _, _ = _build(BAKED8 + ["--snapshot", snap])
    assert "bake" not in baked_calls  # loaded, not baked again
    assert f"loaded snapshot {snap}" in capsys.readouterr().out
    c2w = pose_spherical(30.0, -30.0, 4.0)
    np.testing.assert_array_equal(first(c2w)[0]["rgb_map"],
                                  second(c2w)[0]["rgb_map"])


def test_serve_baked_never_switches_to_online(tmp_path, monkeypatch):
    """A snapshot that does not load is an error, and so is a card that is
    not there: ``--baked`` has no quiet way back to online rendering."""
    snap = tmp_path / "broken.pt"
    torch.save({"format": "something else"}, snap)
    with pytest.raises(ValueError, match="not a baked snapshot"):
        _build(BAKED8 + ["--snapshot", str(snap)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        _build(BAKED8, TINY_FLAGSHIP)


def test_png_round_trip(rng):
    img = rng.integers(0, 256, size=(7, 5, 3)).astype(np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(img)), img)


def test_serve_answers_health_and_render():
    args = argparse.Namespace(width=16, height=12,
                              train_args=["--"] + TINY_FLAGSHIP + CPU)
    render, step, hw = serve.build(args)
    assert (step, hw) == (0, (12, 16))
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(render, step, hw))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            assert json.loads(r.read()) == {"status": "ok", "step": 0,
                                            "resolution": [12, 16]}
        c2w = pose_spherical(30.0, -30.0, 4.0)[:3].tolist()
        req = urllib.request.Request(
            base + "/render", data=json.dumps({"c2w": c2w}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.headers["Content-Type"] == "image/png"
            img = decode_png(r.read())
        assert img.shape == (12, 16, 3)
        with urllib.request.urlopen(
                base + "/render?theta=10&phi=-20&radius=4", timeout=120) as r:
            assert decode_png(r.read()).shape == (12, 16, 3)
        req = urllib.request.Request(
            base + "/render", data=json.dumps({"c2w": c2w, "format": "npy"}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            rgb = np.load(io.BytesIO(r.read()))
        assert rgb.shape == (12, 16, 3) and np.all(np.isfinite(rgb))
        bad = urllib.request.Request(base + "/render", data=b'{"c2w": [1, 2]}')
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=60)
        assert e.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


# The parity path at test size: the hash grid (4 levels) with a fine pass,
# and PE with the classic NeRF, narrowed.
TINY_PARITY = ["--dataset_type", "synthetic", "--use_viewdirs", "--white_bkgd",
               "--n_levels", "4", "--finest_res", "32", "--log2_hashmap_size",
               "12", "--N_samples", "8", "--N_importance", "8"]
TINY_PE = TINY_PARITY + ["--i_embed", "0", "--i_embed_views", "0",
                         "--netdepth", "3", "--netwidth", "32",
                         "--netdepth_fine", "3", "--netwidth_fine", "32"]


@pytest.mark.parametrize("train_flags,server_flags", [
    (TINY_PARITY, []),
    (TINY_PARITY, BAKED8),
    (TINY_PARITY + ["--i_embed_views", "0"], BAKED8 + ["--guided", "4"]),
    (TINY_PE, []),
], ids=["hash_online", "hash_baked", "hash_pe_views_guided", "pe_online"])
def test_serve_parity_field(train_flags, server_flags, baked_calls):
    """A parity field serves online and, for the hash grid, baked (its
    vertex sweep through the hash encode; a field with PE view features
    bakes with them and shades with them)."""
    render, step, hw = _build(server_flags, train_flags + CPU)
    maps, _ = render(pose_spherical(30.0, -30.0, 4.0))
    assert maps["rgb_map"].shape == (10, 12, 3)
    assert all(np.all(np.isfinite(v)) for v in maps.values())
    if server_flags:
        cfg = baked_calls["baked"]["config"]
        views = 0 if "--i_embed_views" in train_flags else 2
        assert cfg.i_embed_views == views and cfg.resolution == 8
        width = baked_calls["baked"]["color_net"][0]["w"].shape[0]
        assert width == (27 if views == 0 else 16) + 15


def test_bake_refuses_a_pe_field():
    """PE has no grid to bake, as in the JAX package."""
    from indoor_nerf_tpu_torch.models.field import init_field_params
    from indoor_nerf_tpu_torch.render.baked import bake_field

    _, tcfg, _ = configs(TINY_PE)
    params = init_field_params(torch.Generator().manual_seed(0), tcfg.render.field)
    with pytest.raises(ValueError, match="NeRFSmall-style grid field"):
        bake_field(params, tcfg.render.field, resolution=8)
