"""Mip-NeRF 360 in the port against the benchmark's plain reference
(``nerfbench/reference/mipnerf360.py``) and against float64 mathematics,
on the CPU at a small size: nets 4 x 64 (its skip layer included at 5 x 64)
and 2 x 32, 8 + 8 + 4 intervals, 16 rays, the reference's seeded weights
loaded into the port's state.

Tolerances, and why:

- the frustum's moments against float64 quadrature over the cone: 1e-5
  relative (the closed form is exact; float32 rounds it, and the variance
  is a difference of close terms, so it is held relative to ``t_delta^2``);
- the contracted Gaussian's diagonal against ``J S J^T`` with ``J`` from
  autograd in float64: 3e-5 of the Gaussian's largest diagonal entry (the
  terms of the port's elementwise expansion cancel in part in float32, as
  the reference's matrix products do);
- the IPE against a float64 Monte-Carlo mean of 400,000 draws of ``sin``
  and ``cos``: 6e-3 absolute, ~4 standard errors of such a mean;
- the resampler, the spacing and the weights: the same float32
  expressions on both sides, bit for bit or to 1e-6;
- a step's loss, interlevel loss and gradients pass through the MLPs'
  GEMMs (the port adds the bias inside the GEMM) and the Gaussians (the
  reference forms 3 x 3 matrices): the loss to 1e-6 relative, each leaf's
  gradient norm to 1e-5 relative to the larger of its own and the median
  leaf's (as the benchmark's ``grad_gap``), each leaf after the update to
  1e-4 of its change's norm (the clipped update is linear in the gradient:
  eps 1e-6 outweighs ``sqrt(nu)``);
- an evaluation render through ``serve.build``: rgb to 1e-5, depth to
  2e-4 relative (a far interval's midpoint lies ~500 away, so its weight's
  rounding moves a pixel's depth by that much).
"""

import math

import numpy as np
import pytest
import torch

from nerfbench.reference import mipnerf360 as ref
from indoor_nerf_tpu_torch import run_nerf, serve
from indoor_nerf_tpu_torch.data.load import load_dataset
from indoor_nerf_tpu_torch.data.scene_files import (
    make_room_blender_scene,
    write_blender_scene,
)
from indoor_nerf_tpu_torch.ops import intervals
from indoor_nerf_tpu_torch.render import proposal
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.train.optim import mipnerf360_lr, named_leaves
from indoor_nerf_tpu_torch.train.step import draw_step, init_train_state, train_step
from indoor_nerf_tpu_torch.train.trainer import build_train_config, make_sampler

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
SMALL = {"netdepth": 4, "netwidth": 64, "prop_netdepth": 2,
         "prop_netwidth": 32, "bottleneck_width": 16, "netwidth_views": 8,
         "proposal_samples": "8,8", "nerf_samples": 4, "N_rand": 16}
SEED = 2**31 + 360
STEP0 = 6000


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("room")
    write_blender_scene(str(d), make_room_blender_scene(8, 24, 24))
    return str(d)


def _flags(scene_dir, extra=(), small=SMALL):
    out = ["--mipnerf360", "--dataset_type", "blender", "--datadir",
           scene_dir] + CPU
    for k, v in small.items():
        out += [f"--{k}", str(v)]
    return out + list(extra)


def _setup(scene_dir, small=SMALL, seed=SEED):
    args = parse_args(_flags(scene_dir, small=small))
    scene = load_dataset(args)
    cfg = build_train_config(args, scene)
    state = init_train_state(torch.Generator().manual_seed(0), cfg)
    spec = ref.make_spec(small, float(scene.hwf[2]))
    params = ref.make_params(spec, seed, "cpu")
    leaves = named_leaves(state["params"])
    assert set(leaves) == set(params)
    with torch.no_grad():
        for k, t in leaves.items():
            t.copy_(params[k])
    sample, _ = make_sampler(args, scene, cfg, seed)
    return args, scene, cfg, state, spec, params, sample


def test_frustum_moments_match_quadrature_over_the_cone():
    """``conical_frustum``'s mean and variances against float64 Gauss-
    Legendre quadrature of the frustum's uniform density: along the axis
    ``t`` weighs ``t^2`` (the cross-section's area), across it a disc of
    radius ``r t`` gives ``r^2 t^2 / 4`` a direction."""
    g = torch.Generator().manual_seed(4)
    o = torch.randn((6, 3), generator=g, dtype=torch.float64)
    d = torch.randn((6, 3), generator=g, dtype=torch.float64)
    t = torch.sort(torch.rand((6, 5), generator=g, dtype=torch.float64)
                   * 20 + 0.05, -1).values
    r = 0.013
    mean, t_var, r_var = intervals.conical_frustum(o.float(), d.float(),
                                                   t.float(), r)
    x, wq = np.polynomial.legendre.leggauss(64)
    t0, t1 = t[:, :-1, None].numpy(), t[:, 1:, None].numpy()
    ts = 0.5 * (t1 - t0) * x + 0.5 * (t1 + t0)
    w = wq * ts ** 2
    m1 = (w * ts).sum(-1) / w.sum(-1)
    m2 = (w * ts ** 2).sum(-1) / w.sum(-1)
    hw2 = (0.5 * (t1 - t0)[..., 0]) ** 2
    want_mean = o.numpy()[:, None] + m1[..., None] * d.numpy()[:, None]
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_var.numpy(), m2 - m1 ** 2, rtol=0,
                               atol=1e-5 * hw2.max())
    np.testing.assert_allclose(r_var.numpy(), r * r * m2 / 4, rtol=1e-5,
                               atol=0)
    # The reference's matrices agree with the port's moments.
    _, cov = ref.gaussians(o.float(), d.float(), t.float(), r)
    dd = d.float()[:, None, :, None] * d.float()[:, None, None, :]
    null = torch.eye(3) - dd / (d.float() ** 2).sum(-1)[:, None, None, None]
    want = t_var[..., None, None] * dd + r_var[..., None, None] * null
    torch.testing.assert_close(cov, want, rtol=1e-5, atol=1e-9)


def test_contracted_covariance_is_the_jacobians():
    """``contract_gaussian``'s mean and diagonal against ``contract`` and
    ``J S J^T`` with ``J`` the autograd Jacobian of the contraction in
    float64, inside and outside the unit ball."""
    g = torch.Generator().manual_seed(5)
    n, s = 5, 7
    o = torch.randn((n, 3), generator=g) * 0.3
    d = torch.randn((n, 3), generator=g)
    t = torch.sort(torch.rand((n, s + 1), generator=g) * 6 + 0.05, -1).values
    mean, t_var, r_var = intervals.conical_frustum(o, d, t, 0.02)
    got_m, got_v = intervals.contract_gaussian(mean, d, t_var, r_var)
    torch.testing.assert_close(got_m, intervals.contract_l2(mean))
    m64 = mean.double().reshape(-1, 3)
    d64 = d.double()[:, None, :].expand(n, s, 3).reshape(-1, 3)
    tv, rv = t_var.double().reshape(-1), r_var.double().reshape(-1)
    dd = d64[:, :, None] * d64[:, None, :]
    cov = tv[:, None, None] * dd + rv[:, None, None] * (
        torch.eye(3, dtype=torch.float64)
        - dd / (d64 ** 2).sum(-1)[:, None, None])
    want = []
    for k in range(m64.shape[0]):
        jac = torch.autograd.functional.jacobian(intervals.contract_l2,
                                                 m64[k])
        want.append(torch.diagonal(jac @ cov[k] @ jac.T))
    want = torch.stack(want).reshape(n, s, 3)
    outside = (m64.norm(dim=-1) > 1).reshape(n, s)
    assert outside.any() and (~outside).any()
    scale = want.amax(-1, keepdim=True).numpy()
    assert np.all(np.abs(got_v.double().numpy() - want.numpy())
                  <= 3e-5 * scale)
    # The reference's full J S J^T has the same diagonal.
    _, rcov = ref.gaussians(o, d, t, 0.02)
    rd = torch.diagonal(ref.contract_cov(mean, rcov), dim1=-2, dim2=-1)
    assert np.all(np.abs(rd.double().numpy() - want.numpy()) <= 3e-5 * scale)


def test_ipe_is_the_expected_sine():
    """The IPE of a Gaussian is the mean of ``sin`` and ``cos`` of its
    scaled draws: against a float64 Monte-Carlo mean."""
    g = torch.Generator().manual_seed(6)
    mean = torch.rand((3, 3), generator=g) * 2 - 1
    var = torch.rand((3, 3), generator=g) * 0.02 + 1e-4
    got = intervals.integrated_pos_enc(mean, var, 4)
    assert got.shape == (3, 24)
    z = torch.randn((3, 400_000, 3), generator=g, dtype=torch.float64)
    x = mean.double()[:, None] + z * var.double().sqrt()[:, None]
    sc = 2.0 ** torch.arange(4, dtype=torch.float64)
    xs = (x[..., None, :] * sc[:, None]).flatten(-2)
    want = torch.cat([torch.sin(xs).mean(1), torch.cos(xs).mean(1)], -1)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=0,
                               atol=6e-3)
    full = intervals.integrated_pos_enc(mean, var, 12)
    torch.testing.assert_close(full, ref.ipe(mean, var), rtol=0, atol=0)


@pytest.mark.parametrize("zeros", [0, 3])
def test_sample_intervals(zeros):
    """Edges sorted, in [0, 1], ``n`` intervals; evaluation deterministic;
    the reference's resampler bit for bit; a uniform histogram gives the
    uniform spacing in evaluation."""
    g = torch.Generator().manual_seed(7)
    n = 32
    edges = torch.sort(torch.rand((n, 13), generator=g), -1).values
    edges[:, 0], edges[:, -1] = 0.0, 1.0
    w = torch.rand((n, 12), generator=g) ** 3
    w[:, :zeros] = 0.0
    u = torch.rand((n, 1), generator=g)
    for draw in (None, u):
        a = intervals.sample_intervals(edges, w, 9, draw)
        assert a.shape == (n, 10)
        assert torch.all(a[:, 1:] >= a[:, :-1])
        assert torch.all(a >= 0) and torch.all(a <= 1)
        torch.testing.assert_close(a, ref.resample(edges, w, 9, draw),
                                   rtol=0, atol=0)
    assert torch.equal(intervals.sample_intervals(edges, w, 9, None),
                       intervals.sample_intervals(edges, w, 9, None))
    whole = torch.tensor([[0.0, 1.0]]).expand(n, 2)
    flat = intervals.sample_intervals(whole, torch.ones(n, 1), 8, None)
    torch.testing.assert_close(flat, torch.linspace(0, 1, 9).expand(n, 9),
                               rtol=0, atol=1e-6)


def test_spacing_and_weights():
    near, far = torch.full((4, 1), 0.05), torch.full((4, 1), 1000.0)
    s = torch.linspace(0, 1, 11).expand(4, 11)
    t = intervals.reciprocal_to_t(s, near, far)
    torch.testing.assert_close(t[:, 0], near[:, 0])
    torch.testing.assert_close(t[:, -1], far[:, 0], rtol=1e-5, atol=0)
    spec = ref.make_spec({}, 30.0)
    assert torch.equal(t, ref.depths(s, spec))
    g = torch.Generator().manual_seed(8)
    sigma = torch.rand((4, 10), generator=g)
    d = torch.randn((4, 3), generator=g)
    chain = proposal.MipNeRF360Chain(proposal.MipNeRF360Config())
    w = chain.weights(sigma, t, d)
    torch.testing.assert_close(w, ref.weights_of(sigma, t, d), rtol=0, atol=0)
    torch.testing.assert_close(w.sum(-1), torch.ones(4), rtol=0, atol=1e-6)


def _step_both(scene_dir, steps=1, small=SMALL):
    args, scene, cfg, state, spec, params, sample = _setup(scene_dir, small)
    state["step"] = state["opt"]["step"] = STEP0
    gen = torch.Generator().manual_seed(5)
    batches, draws, metrics = [], [], []
    for i in range(steps):
        b = {k: torch.from_numpy(v) for k, v in sample(STEP0 + i + 1).items()}
        d = draw_step(gen, cfg, state["step"], b["rays_o"].shape[0])
        assert set(d) == {"u"} and d["u"].shape == (16, 3)
        batches.append(b)
        draws.append(d)
        state, m = train_step(state, b, cfg, draws=d)
        metrics.append(m)
        if i == 0:
            grads = {k: v.clone() / 0.1 for k, v in state["opt"]["mu"].items()}
    rparams = {k: v.clone() for k, v in params.items()}
    res = ref.run_steps(rparams, batches, draws, spec, STEP0)
    return state, metrics, grads, res, rparams, params


@pytest.mark.parametrize("small", [SMALL, dict(SMALL, netdepth=5)],
                         ids=["4x64", "5x64_skip"])
def test_step_matches_reference(scene_dir, small):
    """One step from the reference's weights at step 6000: the loss, the
    interlevel loss, every leaf's clipped gradient and the update."""
    state, metrics, grads, res, rparams, p0 = _step_both(scene_dir, 1, small)
    m = metrics[0]
    assert abs(float(m["loss"]) - res["losses"][0]) <= 1e-6 * res["losses"][0]
    assert abs(float(m["interlevel"]) - res["interlevels"][0]) <= \
        1e-5 * res["interlevels"][0] + 1e-9
    assert res["interlevels"][0] > 0 and m["proposal_update"]
    med = float(np.median(list(res["grad_norms"].values())))
    for k, r in res["grad_norms"].items():
        assert abs(float(grads[k].norm()) - r) <= 1e-5 * max(r, med), k
    total = math.sqrt(sum(float(g.norm()) ** 2 for g in grads.values()))
    assert total == pytest.approx(ref.GRAD_MAX_NORM, rel=1e-5)  # clipped
    leaves = named_leaves(state["params"])
    for k, want in rparams.items():
        moved = float((want - p0[k]).norm())
        assert moved > 0, k
        assert float((leaves[k].detach() - want).norm()) <= 1e-4 * moved, k


def test_three_steps_match_reference(scene_dir):
    state, metrics, _, res, rparams, p0 = _step_both(scene_dir, 3)
    for m, want in zip(metrics, res["losses"]):
        assert abs(float(m["loss"]) - want) <= 1e-5 * want
    leaves = named_leaves(state["params"])
    for k, want in rparams.items():
        change = float((want - p0[k]).norm())
        got = float((leaves[k].detach() - p0[k]).norm())
        assert abs(got - change) <= 1e-4 * change, k


def test_learning_rate_schedule():
    spec = ref.make_spec({}, 30.0)
    for t in (0, 1, 100, 511, 512, 6000, 250_000, 300_000):
        assert mipnerf360_lr(2e-3, 250, t) == ref.lr_at(spec, t)
    assert mipnerf360_lr(2e-3, 250, 0) == pytest.approx(2e-5)
    assert mipnerf360_lr(2e-3, 250, 512) == pytest.approx(
        2e-3 * math.exp(512 / 250_000 * math.log(0.01)))
    assert mipnerf360_lr(2e-3, 250, 250_000) == pytest.approx(2e-5)


def test_eval_render_matches_reference(scene_dir, tmp_path):
    """``serve.build`` renders the checkpoint of the reference's weights at
    another resolution than the training views' (the pixel radius follows
    the focal length): rgb to 1e-5, depth to 1e-5 of its mean."""
    from indoor_nerf_tpu_torch.utils.checkpoint import save_checkpoint

    args, scene, cfg, state, spec, params, _ = _setup(scene_dir)
    ckpt = save_checkpoint(str(tmp_path), 7, state)
    W = H = 12
    render, _, hw = serve.build(serve.parse_server_args(
        ["--width", str(W), "--height", str(H), "--"]
        + _flags(scene_dir, ["--ft_path", ckpt])))
    assert hw == (H, W)
    pose = np.asarray(scene.poses[0], np.float32)
    maps, _ = render(pose)
    focal = float(scene.hwf[2]) * W / scene.hwf[1]
    from nerfbench.reference import render as ref_render
    ro, rd = ref_render.image_rays(H, W, focal, torch.as_tensor(pose[:3, :4]))
    want = ref.render_rays(params, ro, rd, ref.make_spec(
        SMALL, focal), None)
    np.testing.assert_allclose(maps["rgb_map"].reshape(-1, 3),
                               want["rgb"].detach().numpy(), rtol=0, atol=1e-5)
    dep = want["depth"].detach().numpy()
    np.testing.assert_allclose(maps["depth_map"].reshape(-1), dep, rtol=2e-4,
                               atol=0)


def test_config_file_trains_one_step(scene_dir, tmp_path, monkeypatch):
    """The config file parses to the preset and trains one step through
    ``run_nerf`` (cut to the small nets here), writing its checkpoint."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "configs", "mipnerf360",
                        "norcliffe_common_room.txt")
    a = parse_args(["--config", path])
    assert a.mipnerf360 and not a.nerfacto and not a.no_batching
    assert (a.N_rand, a.netdepth, a.netwidth, a.proposal_samples,
            a.nerf_samples, a.prop_netdepth, a.prop_netwidth,
            a.bottleneck_width, a.netwidth_views, a.lrate,
            a.distortion_loss_weight) == (16384, 8, 1024, "64,64", 32, 4, 256,
                                          256, 128, 2e-3, 0.01)
    argv = ["--config", path, "--datadir", scene_dir, "--basedir",
            str(tmp_path), "--n_iters", "1"] + CPU
    for k, v in SMALL.items():
        argv += [f"--{k}", str(v)]
    out = run_nerf.main(argv)
    state = out["state"]
    assert state["step"] == 1 and np.isfinite(out["losses"][0])
    assert sorted(state["params"]) == ["nerf_mlp", "proposal_mlp"]
    assert sorted(f for f in os.listdir(out["logdir"])
                  if f.endswith(".ckpt")) == ["000001.ckpt"]


def test_counters_count_each_level(scene_dir):
    _, _, cfg, state, _, _, sample = _setup(scene_dir)
    proposal.reset_counts()
    b = {k: torch.from_numpy(v) for k, v in sample(1).items()}
    train_step(state, b, cfg, torch.Generator().manual_seed(1))
    assert proposal.sample_counts() == {"proposal_0": 16 * 8,
                                        "proposal_1": 16 * 8,
                                        "field": 16 * 4, "updates": 1}


@pytest.mark.parametrize("flag", [
    ["--use_occupancy"], ["--N_importance", "8"], ["--use_structural_priors"],
    ["--use_quantization"], ["--ray_groups", "1,1,1,1"],
    ["--mesh_shape", "model:2"], ["--ema_decay", "0.9"],
    ["--table_decay_weight", "0.1"], ["--precision", "bf16"]])
def test_refusals(scene_dir, flag):
    args = parse_args(_flags(scene_dir, flag))
    with pytest.raises(ValueError, match="--mipnerf360 refuses"):
        build_train_config(args, load_dataset(args))


def test_refusals_of_serving_and_of_two_models(scene_dir):
    with pytest.raises(ValueError, match="--baked with --mipnerf360"):
        serve.build(serve.parse_server_args(
            ["--baked", "--width", "8", "--height", "8", "--"]
            + _flags(scene_dir)))
    with pytest.raises(ValueError, match="one model at a time"):
        load_dataset(parse_args(_flags(scene_dir, ["--nerfacto"])))
