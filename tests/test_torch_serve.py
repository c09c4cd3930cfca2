"""The port's render server, in process on the CPU, plus its config
plumbing and the numpy-only copies it serves from."""

import argparse
import io
import json
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
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        configs(["--dataset_type", "synthetic"])  # i_embed 1
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        configs(TINY_FLAGSHIP + ["--use_quantization"])


def test_occupancy_with_importance_is_refused():
    """The JAX package fails on the pair (its step reads ``out["rgb0"]``,
    which the occupancy branch never returns); the port says so."""
    with pytest.raises(ValueError, match="JAX package fails on the pair"):
        configs(TINY_FLAGSHIP + ["--N_importance", "8"])[1]


@pytest.mark.parametrize("flag", [
    ["--baked"], ["--baked_res", "128"], ["--baked_geo_res", "0"],
    ["--baked_dtype", "int8"], ["--snapshot", "baked.npz"], ["--guided", "4"]])
def test_serve_refuses_baked_flags_by_item(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7"):
        serve.main(flag + ["--"] + TINY_FLAGSHIP + CPU)


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
