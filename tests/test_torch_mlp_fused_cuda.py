"""The fused NeRFSmall kernel (csrc/nerf_small_fused.cu) on the card
(marker ``cuda``; skipped without one):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_mlp_fused_cuda.py

This file imports no jax, so it runs where the card is. The kernel is held
against the eager chain (``nerf_small_plain``: cuBLAS with TF32 off) and
both against a float64 evaluation of the same chain. Tolerance, and why:
the kernel sums each dot product over k in ascending order with fmaf,
cuBLAS in its own blocked order; both are float32 sums of at most 64
terms, so each lies within a few float32 roundings of the exact sum, and
the two within 1e-5 of each channel's largest value (rgb logits, sigma).
The normal is divided by its length, which magnifies either's rounding on
rows where the length is small, so every channel is also held against
float64: the kernel's largest error at most 4x cuBLAS's, plus 1e-6 of the
channel's largest value.
"""

import copy

import numpy as np
import pytest
import torch
from unittest import mock

import indoor_nerf_tpu_torch  # noqa: F401  (sets the TF32 policy)
from indoor_nerf_tpu_torch.cuda_build import launch_counts, reset_counts
from indoor_nerf_tpu_torch.models import field as field_mod
from indoor_nerf_tpu_torch.models import mlp_fused
from indoor_nerf_tpu_torch.models.mlp import init_nerf_small
from indoor_nerf_tpu_torch.models.mlp_fused import (
    SUPPORTED_INPUTS,
    SUPPORTED_VIEWS,
    nerf_small_fused,
    nerf_small_plain,
    pack_weights,
    packed,
)
from indoor_nerf_tpu_torch.ops.encoding import positional_encode, sh_encode

pytestmark = pytest.mark.cuda

TOL = 1e-5  # of a channel's largest value, kernel against cuBLAS
F64_FACTOR, F64_FLOOR = 4.0, 1e-6
CHANNELS = {"rgb": slice(0, 3), "sigma": slice(3, 4), "normal": slice(4, 7)}
# The serving cell's limits (nerfbench/limits/room_blockhash.serve.json).
SERVE_LIMITS = {"rgb_p50_gap": 5e-7, "depth_p50_gap": 8e-7,
                "rgb_p99_gap": 1.2e-5}
SERVE_FLAGS = ["--flagship", "--dataset_type", "synthetic", "--use_viewdirs",
               "--white_bkgd", "--predict_normals"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def _net(device, normals, seed=0, dead=0, input_ch=32, views=16):
    """NeRFSmall at the kernel's widths; ``dead`` hidden units of the first
    layer with zero weights, whose ReLU input is exactly 0 on every row."""
    net = init_nerf_small(torch.Generator().manual_seed(seed),
                          input_ch=input_ch, input_ch_views=views,
                          predict_normals=normals).to(device)
    if dead:
        with torch.no_grad():
            net.sigma_net[0]["w"][:, :dead] = 0.0
    return net


def _counts():
    """(nerf_small_fused launches, rows) since the last reset_counts."""
    counts = launch_counts()
    return counts["nerf_small_fused"], counts["nerf_small_fused.rows"]


def _inputs(device, rays, samples, seed=0, zero_rows=0, keep_share=0.8,
            input_ch=32, views=16):
    """Features, view features (SH of degree 4 plus a latent's offset at
    16, a positional encoding at 27, None at 0) and keep flags."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = rays * samples
    feats = torch.randn((n, input_ch), generator=g, device=device)
    feats[:zero_rows] = 0.0  # every first-layer ReLU input exactly 0
    dirs = torch.nn.functional.normalize(
        torch.randn((rays, 3), generator=g, device=device), dim=-1)
    vf = None
    if views == 16:
        vf = (sh_encode(dirs, degree=4)
              + 0.1 * torch.randn((rays, 16), generator=g, device=device))
    elif views:
        vf = positional_encode(dirs, (views - 3) // 6)
        assert vf.shape[-1] == views
    keep = torch.rand(n, generator=g, device=device) < keep_share
    return feats, None if vf is None else vf.contiguous(), keep


def _hold(net, feats, vf, samples, keep):
    net64 = copy.deepcopy(net).double()
    with torch.inference_mode():
        reset_counts()
        got = nerf_small_fused(net, feats, vf, samples, keep)
        assert _counts() == (1, feats.shape[0])
        want = nerf_small_plain(net, feats, vf, samples, keep)
        exact = nerf_small_plain(net64, feats.double(),
                                 None if vf is None else vf.double(),
                                 samples, keep)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert not bool(got[~keep, 3].any())  # sigma zeroed outside the box
    for name, sl in CHANNELS.items():
        if sl.start >= got.shape[1]:
            continue
        g, w, e = got[:, sl].double(), want[:, sl].double(), exact[:, sl]
        scale = float(w.abs().max())
        if name != "normal":
            assert float((g - w).abs().max()) <= TOL * scale, name
        err, ref = float((g - e).abs().max()), float((w - e).abs().max())
        assert err <= F64_FACTOR * ref + F64_FLOOR * scale, (name, err, ref)
    if got.shape[1] == 7:
        norms = got[:, 4:].norm(dim=-1)
        assert float((norms - 1).abs().max()) <= 1e-5
    return got, want


@pytest.mark.parametrize("normals", [True, False], ids=["flagship", "hashgrid"])
@pytest.mark.parametrize("rays,samples", [(4000, 32), (333, 192), (1001, 32)],
                         ids=["s32", "s192", "ragged"])
def test_kernel_matches_the_eager_chain(card, normals, rays, samples):
    """At the flagship's widths with the normal net and the hash grid's
    without; 32 and 192 samples a ray; a row count that is not a multiple
    of the kernel's tile (1001 x 32 = 32,032 = 250.25 tiles of 128; 333 x
    192 = 63,936 = 499.5); rows outside the box; ReLU inputs exactly 0 (8
    dead hidden units, and rows of zero features)."""
    net = _net(card, normals, dead=8)
    feats, vf, keep = _inputs(card, rays, samples, zero_rows=100)
    _hold(net, feats, vf, samples, keep)


@pytest.mark.parametrize("input_ch", SUPPORTED_INPUTS)
@pytest.mark.parametrize("views", SUPPORTED_VIEWS)
@pytest.mark.parametrize("normals", [True, False])
def test_every_instantiated_width(card, normals, views, input_ch):
    """Each of the kernel's instantiations: the parser's inputs of 16 and
    32 features, no view features, SH's 16 and the positional encoding's
    27, with and without the normal net; ragged rows, rows outside the box
    and dead units."""
    net = _net(card, normals, dead=4, input_ch=input_ch, views=views)
    feats, vf, keep = _inputs(card, 777, 32, zero_rows=50, input_ch=input_ch,
                              views=views)
    _hold(net, feats, vf, 32, keep)


def test_one_sample_a_ray_and_one_row(card):
    """S = 1 (a ray for every row of a tile) and a single row."""
    net = _net(card, True, seed=1)
    for rays in (1, 300):
        feats, vf, keep = _inputs(card, rays, 1, seed=rays)
        _hold(net, feats, vf, 1, keep)


def test_kernel_fills_the_card(card):
    """Two blocks an SM at the serving widths; at least one at every
    other (27 view features with the normal net need more shared memory
    than half an SM)."""
    assert mlp_fused.blocks_per_sm(32, 16, True) >= 2
    assert mlp_fused.blocks_per_sm(32, 16, False) >= 2
    for i in SUPPORTED_INPUTS:
        for v in SUPPORTED_VIEWS:
            for normals in (True, False):
                assert mlp_fused.blocks_per_sm(i, v, normals) >= 1


def test_refusals(card):
    net = _net(card, True)
    feats, vf, keep = _inputs(card, 64, 32)
    with pytest.raises(TypeError, match="float32"):
        nerf_small_fused(net, feats.double(), vf, 32, keep)
    with pytest.raises(TypeError, match="bool"):
        nerf_small_fused(net, feats, vf, 32, keep.to(torch.uint8))
    wide = torch.randn((feats.shape[0], 64), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        nerf_small_fused(net, wide[:, ::2], vf, 32, keep)
    with pytest.raises(ValueError, match="shape"):
        nerf_small_fused(net, feats, vf[:10], 32, keep)
    with pytest.raises(ValueError, match="rays of 7 samples"):
        nerf_small_fused(net, feats, vf, 7, keep)
    with pytest.raises(ValueError, match="nerf_small_fused is built for"):
        nerf_small_fused(init_nerf_small(torch.Generator(), hidden_dim=32
                                         ).to(card), feats, vf, 32, keep)
    with pytest.raises(ValueError, match="view features"):
        nerf_small_fused(net, feats, None, 32, keep)
    assert nerf_small_fused(net, feats[:0], vf[:0], 32, keep[:0]).shape == (0, 7)


def _serving(card, flags=SERVE_FLAGS, size=800):
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.models.field import init_field_params, serving_params
    from indoor_nerf_tpu_torch.render.renderer import pose_rays
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    cli = parse_args(flags)
    scene = load_dataset(cli)
    cfg = build_train_config(cli, scene)
    g = torch.Generator(device=card).manual_seed(1)
    params = init_field_params(g, cfg.render.field, card)
    params["table"] = torch.randn(params["table"].shape, generator=g, device=card)
    params = serving_params(params, cfg.render.field)
    occ = None
    if cfg.render.occupancy is not None:
        occ = {"density": 4.0 * torch.rand(cfg.render.occupancy.n_cells,
                                            generator=g, device=card)}
    H = W = size
    focal = scene.hwf[2] * (W / scene.hwf[1])
    K = torch.tensor([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                     dtype=torch.float32, device=card)
    c2w = torch.as_tensor(scene.poses[scene.i_test[0]][:3, :4],
                          dtype=torch.float32, device=card)
    rays = pose_rays(c2w[None], K, H, W, scene.near, scene.far, cfg.render)
    return cfg, params, occ, rays, scene.far


def test_800x800_render_against_the_eager_renderer(card):
    """One 800x800 request through the kernel and through the eager chain:
    the per-pixel gaps at the serving cell's statistics, under its limits;
    2 launches (tiles of 524,288 rays) and every sample row counted."""
    from indoor_nerf_tpu_torch.render.renderer import render_ray_tiles

    cfg, params, occ, rays, far = _serving(card)
    samples = cfg.render.n_occ_samples
    reset_counts()
    got = render_ray_tiles(params, *rays, cfg.render, 524288, occ)
    assert _counts() == (2, 800 * 800 * samples)
    with mock.patch.object(field_mod, "fused_applies", return_value=False):
        want = render_ray_tiles(params, *rays, cfg.render, 524288, occ)
    assert launch_counts()["nerf_small_fused"] == 2
    _hold_maps(got, want, far)


def _hold_maps(got, want, far):
    """The per-pixel gaps of two renders at the serving cell's statistics,
    under its limits."""
    rgb = (got["rgb_map"] - want["rgb_map"]).abs().max(-1).values
    depth = (got["depth_map"] - want["depth_map"]).abs() / far
    gaps = {"rgb_p50_gap": float(torch.quantile(rgb.double(), 0.5)),
            "depth_p50_gap": float(torch.quantile(depth.double(), 0.5)),
            "rgb_p99_gap": float(torch.quantile(rgb.double(), 0.99))}
    acc = got["acc_map"]
    assert float(acc.mean()) > 0.05  # the rays see the field
    for k, lim in SERVE_LIMITS.items():
        assert gaps[k] <= lim, (k, gaps[k])


def test_parser_default_field_renders_through_the_kernel(card):
    """The parser's default field (the --i_embed 1 hash grid without
    --use_viewdirs: no view features, no normal net), rendered under
    inference mode as an evaluation render or the server renders it: a
    launch a tile over every sample row, and the eager renderer's image
    within the serving limits."""
    from indoor_nerf_tpu_torch.render.renderer import render_ray_tiles

    cfg, params, occ, rays, far = _serving(
        card, ["--dataset_type", "synthetic", "--white_bkgd"], size=200)
    fc = cfg.render.field
    assert fc.i_embed == 1 and not fc.use_viewdirs and occ is None
    with torch.no_grad():
        # A denser field than the seeded one, so most rays meet it: the
        # sigma column positive, over hidden units that are.
        params["coarse"].sigma_net[1]["w"][:, 0].abs_().mul_(4.0)
    reset_counts()
    with torch.inference_mode():
        got = render_ray_tiles(params, *rays, cfg.render, 32768, occ)
    assert _counts() == (
        2, 200 * 200 * cfg.render.n_samples)
    with mock.patch.object(field_mod, "fused_applies", return_value=False):
        want = render_ray_tiles(params, *rays, cfg.render, 32768, occ)
    _hold_maps(got, want, far)


def test_training_step_launches_nothing_and_repacks_after_it(card):
    """A training step runs the eager chain (autograd); its fused RAdam
    update counts as an in-place write, so the next evaluation query packs
    the updated weights."""
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.step import (
        draw_step,
        init_train_state,
        train_step,
    )
    from indoor_nerf_tpu_torch.train.trainer import one_batch

    args = parse_args(SERVE_FLAGS + ["--N_rand", "1024", "--device", "cuda"])
    cfg, batch = one_batch(args, card)
    state = init_train_state(torch.Generator(device=card).manual_seed(0), cfg,
                             card)
    net = state["params"]["coarse"]
    state["opt"]["step"] = 10  # the parameters move in this step
    before = packed(net).clone()
    draws = draw_step(torch.Generator(device=card).manual_seed(1), cfg, 0, 1024)
    reset_counts()
    state, m = train_step(state, batch, cfg, draws=draws)
    torch.cuda.synchronize()
    assert np.isfinite(float(m["loss"]))
    assert launch_counts()["nerf_small_fused"] == 0
    net = state["params"]["coarse"]
    after = packed(net)
    assert not torch.equal(after, before)
    assert torch.equal(after, pack_weights(net))


def test_acaq_step_launches_nothing(card):
    """An A-CAQ controller step in MDL mode: its unquantized anchor renders
    without autograd, and is a training step's query, so it keeps the
    eager chain with the rest of the step."""
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.step import (
        acaq_active,
        draw_step,
        init_train_state,
        train_step,
    )
    from indoor_nerf_tpu_torch.train.trainer import one_batch

    args = parse_args(SERVE_FLAGS + [
        "--N_rand", "1024", "--device", "cuda", "--use_quantization",
        "--use_acaq", "--acaq_start_iter", "10"])
    cfg, batch = one_batch(args, card)
    state = init_train_state(torch.Generator(device=card).manual_seed(0), cfg,
                             card)
    state["step"] = 10
    assert acaq_active(cfg, 10)
    assert cfg.render.field.quant.target_metric is None
    draws = draw_step(torch.Generator(device=card).manual_seed(1), cfg, 10,
                      1024)
    reset_counts()
    state, m = train_step(state, batch, cfg, draws=draws)
    torch.cuda.synchronize()
    assert np.isfinite(float(m["loss"]))
    assert launch_counts()["nerf_small_fused"] == 0
