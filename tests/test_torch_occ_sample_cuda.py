"""The occupancy sampler's kernel (csrc/occ_sample.cu) on the card (marker
``cuda``; skipped without one):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_occ_sample_cuda.py

This file imports no jax, so it runs where the card is. Tolerance: none.
The kernel computes the plain chain (``occupancy_z_vals_plain``) in its op
order and takes each sum over a ray in the order torch's CUDA reduction
and scan take for the call's ray count, so its samples equal the plain
chain's bit for bit, and so do the renders and the training step's loss
downstream. The emulated orders are also held against torch.sum and
torch.cumsum themselves.
"""

import pytest
import torch
from unittest import mock

from indoor_nerf_tpu_torch.cuda_build import launch_counts, reset_counts
from indoor_nerf_tpu_torch.ops import occupancy as occ_mod
from indoor_nerf_tpu_torch.ops.occupancy import (
    OccupancyConfig,
    occupancy_z_vals,
    occupancy_z_vals_plain,
    torch_scan_chunk,
    torch_sum_width,
)
from indoor_nerf_tpu_torch.ops.sampling import draw_pdf_u

pytestmark = pytest.mark.cuda

BOX = ((-2.0, -1.6, -1.2), (2.2, 1.8, 1.5))
SERVE_TILE, SHORT_TILE = 524288, 800 * 800 - 524288
SERVE_FLAGS = ["--flagship", "--dataset_type", "synthetic", "--use_viewdirs",
               "--white_bkgd", "--predict_normals"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def _config(weighting="transmittance", m=128):
    return OccupancyConfig(bbox_min=BOX[0], bbox_max=BOX[1], resolution=64,
                           n_candidates=m, weighting=weighting)


def _inputs(dev, config, n, samples, draws, miss=0.0, zero=False, seed=0):
    """Rays from inside the box in every direction, |d| in [0.8, 1.4]; a
    grid of scattered dense cells (8%, density up to 60) among empty ones;
    ``miss`` of the rays start outside the box and point away."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ro = torch.rand((n, 3), generator=g, device=dev) - 0.5
    rd = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=g, device=dev), dim=-1)
    rd = rd * (0.8 + 0.6 * torch.rand((n, 1), generator=g, device=dev))
    k = int(n * miss)
    ro[:k] = 9.0
    rd[:k] = rd[:k].abs()
    near = torch.full((n, 1), 0.1, device=dev)
    far = torch.full((n, 1), 4.0, device=dev)
    r = torch.rand(config.n_cells, generator=g, device=dev)
    density = torch.where(r < 0.08, 60.0 * r, torch.zeros_like(r))
    if zero:
        density.zero_()
    t_rand = (torch.rand((n, config.n_candidates), generator=g, device=dev)
              if draws else None)
    u = draw_pdf_u(g, n, samples) if draws else None
    return ro, rd, near, far, {"density": density}, t_rand, u


# (name, weighting, M, S, rays, draws, step, extra inputs)
CASES = [
    ("serving_tile", "transmittance", 128, 32, SERVE_TILE, False, None, {}),
    ("short_tile", "transmittance", 128, 32, SHORT_TILE, False, None, {}),
    ("training_batch", "transmittance", 128, 32, 1024, True, 5000, {}),
    ("warmup_step", "transmittance", 128, 32, 1024, True, 10, {}),
    ("density", "density", 128, 32, 65536, False, None, {}),
    ("density_training", "density", 128, 32, 4096, True, 5000, {}),
    ("m32_s8", "transmittance", 32, 8, 65536, True, 5000, {}),
    ("m128_s64", "transmittance", 128, 64, 65536, False, None, {}),
    ("m128_s64_density", "density", 128, 64, 65536, True, 5000, {}),
    ("ragged_m100_s40", "transmittance", 100, 40, 4096, True, 5000, {}),
    ("caps_m128_s256", "transmittance", 128, 256, 4096, True, 5000, {}),
    ("tiny_batch", "transmittance", 128, 32, 8, True, 5000, {}),
    ("rows_at_the_scan_switch", "density", 128, 32, 65537, False, None, {}),
    ("rays_miss_the_box", "transmittance", 128, 32, 65536, False, None,
     {"miss": 0.5}),
    ("zero_grid", "transmittance", 128, 32, 65536, False, None,
     {"zero": True}),
    ("zero_grid_density", "density", 128, 64, 65536, False, None,
     {"zero": True}),
    ("u_one", "transmittance", 128, 32, 4096, True, 5000, {"u_one": True}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_is_the_plain_chain_bit_for_bit(card, case):
    _, weighting, m, samples, n, draws, step, extra = case
    config = _config(weighting, m)
    extra = dict(extra)
    u_one = extra.pop("u_one", False)
    ro, rd, near, far, occ, t_rand, u = _inputs(card, config, n, samples,
                                                draws, **extra)
    if u_one:  # every draw at 1 exactly: the CDF's last entry decides
        u = torch.ones_like(u)
    with torch.inference_mode():
        reset_counts()
        got = occupancy_z_vals(ro, rd, near, far, occ, config, samples, step,
                               t_rand=t_rand, u=u)
        counts = launch_counts()
        plain = occupancy_z_vals_plain(ro, rd, near, far, occ, config,
                                       samples, step, t_rand=t_rand, u=u)
        torch.cuda.synchronize()
    assert (counts["occ_sample"], counts["occ_sample.rays"]) == (1, n)
    assert got.shape == (n, samples) and bool(torch.isfinite(got).all())
    assert bool(((got >= near) & (got <= far)).all())
    mismatch = float((got != plain).double().mean())
    assert mismatch == 0.0, (mismatch, float((got - plain).abs().max()))


def _emulated_sum(x, width):
    """torch.sum(x, -1) in the order of ``width`` threads a row."""
    pad = torch.zeros((x.shape[0], 4 * max(width, 32)), device=x.device)
    pad[:, :x.shape[1]] = x
    if width > 32:
        a = pad[:, 0:64] + pad[:, 64:128]
        v, width = a[:, :32] + a[:, 32:64], 32
    else:
        seg = [pad[:, i * width:(i + 1) * width] for i in range(4)]
        v = ((seg[0] + seg[1]) + seg[2]) + seg[3]
    while width > 1:
        width //= 2
        v = v[:, :width] + v[:, width:2 * width]
    return v[:, 0]


def _emulated_cumsum(x, chunk):
    """torch.cumsum(x, -1) in chunks of ``chunk``, each a Sklansky scan."""
    rows, n = x.shape
    width = -(-n // chunk) * chunk
    pad = torch.zeros((rows, width), device=x.device)
    pad[:, :n] = x
    idx = torch.arange(chunk, device=x.device)
    carry, out = torch.zeros(rows, device=x.device), []
    for c in range(width // chunk):
        ch = pad[:, c * chunk:(c + 1) * chunk].clone()
        ch[:, 0] = ch[:, 0] + carry
        m = 0
        while (1 << m) < chunk:
            ti = idx[(idx >> m) & 1 == 1]
            ch[:, ti] = ch[:, ti] + ch[:, ((ti >> (m + 1)) << (m + 1)) + (1 << m) - 1]
            m += 1
        carry = ch[:, -1]
        out.append(ch)
    return torch.cat(out, 1)[:, :n]


@pytest.mark.parametrize("rows", [8, 16, 1024, 65536, 65537, 524288])
@pytest.mark.parametrize("n", [7, 31, 63, 64, 126, 127])
def test_the_orders_are_torchs(card, rows, n):
    """The widths and chunks the kernel is given reproduce torch.sum and
    torch.cumsum on this card's torch, bit for bit."""
    g = torch.Generator(device=card).manual_seed(n * rows)
    x = torch.rand((rows, n), generator=g, device=card) ** 3
    assert torch.equal(_emulated_sum(x, torch_sum_width(n, rows)),
                       torch.sum(x, -1))
    assert torch.equal(_emulated_cumsum(x, torch_scan_chunk(n, rows)),
                       torch.cumsum(x, -1))


def _serving(dev, size=800):
    """The flagship served as the benchmark serves it: a seeded field, a
    U(0, 4) grid, the rays of a test pose at ``size`` x ``size``."""
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.models.field import init_field_params, serving_params
    from indoor_nerf_tpu_torch.render.renderer import pose_rays
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    cli = parse_args(SERVE_FLAGS)
    scene = load_dataset(cli)
    cfg = build_train_config(cli, scene)
    g = torch.Generator(device=dev).manual_seed(1)
    params = init_field_params(g, cfg.render.field, dev)
    params["table"] = torch.randn(params["table"].shape, generator=g, device=dev)
    params = serving_params(params, cfg.render.field)
    occ = {"density": 4.0 * torch.rand(cfg.render.occupancy.n_cells,
                                        generator=g, device=dev)}
    focal = scene.hwf[2] * (size / scene.hwf[1])
    K = torch.tensor([[focal, 0, 0.5 * size], [0, focal, 0.5 * size],
                      [0, 0, 1]], dtype=torch.float32, device=dev)
    c2w = torch.as_tensor(scene.poses[scene.i_test[0]][:3, :4],
                          dtype=torch.float32, device=dev)
    rays = pose_rays(c2w[None], K, size, size, scene.near, scene.far,
                     cfg.render)
    return cfg, params, occ, rays, scene.far


def test_800x800_request_one_launch_a_tile(card):
    """One 800x800 request in the serving tiles (524,288 + 115,712 rays):
    a launch a tile over every ray, and every map the one rendered through
    the plain chain, bit for bit."""
    from indoor_nerf_tpu_torch.render import renderer

    cfg, params, occ, rays, far = _serving(card)
    reset_counts()
    got = renderer.render_ray_tiles(params, *rays, cfg.render, SERVE_TILE, occ)
    counts = launch_counts()
    assert (counts["occ_sample"], counts["occ_sample.rays"]) == (2, 800 * 800)
    with mock.patch.object(renderer, "occupancy_z_vals",
                           occupancy_z_vals_plain):
        want = renderer.render_ray_tiles(params, *rays, cfg.render,
                                         SERVE_TILE, occ)
    assert launch_counts()["occ_sample"] == 2
    assert float(got["acc_map"].mean()) > 0.05  # the rays see the field
    for k in renderer.MAP_KEYS:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("step", [10, 5000], ids=["warmup", "past_warmup"])
def test_training_step_one_launch(card, step):
    """A flagship training step of 1,024 rays, in the grid's warm-up and
    past it: one launch over the batch's rays, inside the step as it runs
    (no gradient reaches the samples), and the step's loss that of the
    same step through the plain chain, bit for bit."""
    import copy

    from indoor_nerf_tpu_torch.render import renderer
    import numpy as np

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
    state["step"] = step
    draws = draw_step(torch.Generator(device=card).manual_seed(1), cfg, step,
                      1024)
    twin = copy.deepcopy(state)
    reset_counts()
    state, m = train_step(state, batch, cfg, draws=draws)
    torch.cuda.synchronize()
    assert np.isfinite(float(m["loss"]))
    counts = launch_counts()
    assert (counts["occ_sample"], counts["occ_sample.rays"]) == (1, 1024)
    with mock.patch.object(renderer, "occupancy_z_vals",
                           occupancy_z_vals_plain):
        _, m_plain = train_step(twin, batch, cfg, draws=draws)
    assert launch_counts()["occ_sample"] == 1
    assert torch.equal(m["loss"], m_plain["loss"])


def test_strided_inputs_and_refusals_on_the_card(card):
    """Strided rays and draws (a step's patch rays can be) reach the kernel
    as contiguous copies, and its samples are the plain chain's on the
    same strided inputs; the kernel's wrapper itself refuses a strided
    input, and a refused input raises before any launch."""
    config = _config()
    ro, rd, near, far, occ, t_rand, u = _inputs(card, config, 64, 32, True)
    strided = {"rays_o": torch.cat([ro, ro], 1)[:, ::2],
               "rays_d": torch.cat([rd, rd], 1)[:, ::2],
               "t_rand": torch.cat([t_rand, t_rand], 1)[:, ::2]}
    assert not any(t.is_contiguous() for t in strided.values())
    reset_counts()
    got = occupancy_z_vals(strided["rays_o"], strided["rays_d"], near, far,
                           occ, config, 32, 5000, t_rand=strided["t_rand"],
                           u=u)
    assert launch_counts()["occ_sample"] == 1
    assert torch.equal(got, occupancy_z_vals_plain(
        strided["rays_o"], strided["rays_d"], near, far, occ, config, 32,
        5000, t_rand=strided["t_rand"], u=u))
    reset_counts()
    with pytest.raises(ValueError, match="rays_d contiguous"):
        occ_mod.occ_sample(ro, strided["rays_d"], near, far, occ["density"],
                           config, 32, False)
    with pytest.raises(TypeError, match="u as torch.float32"):
        occupancy_z_vals(ro, rd, near, far, occ, config, 32, 5000,
                         t_rand=t_rand, u=u.double())
    assert launch_counts()["occ_sample"] == 0
    assert occ_mod.occ_sample(ro[:0], rd[:0], near[:0], far[:0],
                              occ["density"], config, 32, False).shape == (0, 32)
