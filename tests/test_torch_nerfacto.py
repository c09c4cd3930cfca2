"""Nerfacto in the port against the benchmark's plain reference
(``nerfbench/reference/nerfacto.py``) on the CPU, at a small size: 64
rays, (16, 8) proposal samples and 8 field samples, tables of 2^10 rows,
the reference's seeded weights loaded into the port's state.

Tolerances, and why:

- the sampling arithmetic (contraction, spacing, initial edges, PDF
  sampler, interval weights) is the same float32 expression in both, so
  it is held bit for bit, or to 1 ulp where the two sum in another order;
- a step's loss and each leaf's gradient pass through the hash grids'
  ``index_add_``-shaped sums and the MLPs' GEMMs, summed in another order
  on each side: the loss to 1e-6 relative, each leaf's gradient norm to
  1e-5 relative to the larger of its own and the median leaf's (as the
  benchmark's ``grad_gap``), each gradient element to 1e-4 relative plus
  1e-7 absolute;
- an update divides by ``sqrt(nu) + 1e-15``, which turns a relative error
  of a gradient element into the same of the step: the parameters after
  one update to 1e-5 relative plus 1e-6 of the learning rate absolute;
  after three steps each leaf's change by its norm (an entry whose
  gradient is all but zero takes a near-sign step);
- an evaluation render through ``serve.build`` to 1e-5 on rgb and 1e-5 of
  the mean depth on depth.

The bfloat16 variant (``--precision bf16``: the MLPs' operands rounded to
bfloat16) fails at least one of them.
"""

import argparse

import numpy as np
import pytest
import torch

CPU = ["--device", "cpu"]
from nerfbench.reference import nerfacto as ref
from nerfbench.reference import render as ref_render
from indoor_nerf_tpu_torch import serve
from indoor_nerf_tpu_torch.data.scene_files import (
    make_room_blender_scene,
    write_blender_scene,
)
from indoor_nerf_tpu_torch.losses.distortion import interval_distortion
from indoor_nerf_tpu_torch.losses.interlevel import interlevel_loss
from indoor_nerf_tpu_torch.ops import intervals
from indoor_nerf_tpu_torch.render import proposal
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.train.optim import named_leaves
from indoor_nerf_tpu_torch.train.step import draw_step, init_train_state, train_step
from indoor_nerf_tpu_torch.train.trainer import build_train_config, make_sampler
from indoor_nerf_tpu_torch.data.load import load_dataset
from indoor_nerf_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

SMALL = {"n_levels": 4, "finest_res": 64, "log2_hashmap_size": 10,
         "proposal_log2_hashmap_size": 10, "proposal_samples": "16,8",
         "nerf_samples": 8, "N_rand": 64}
SEED = 2**31 + 77
STEP0 = 6000  # past the proposal warm-up and the anneal


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("room")
    write_blender_scene(str(d), make_room_blender_scene(8, 24, 24))
    return str(d)


def _flags(scene_dir, extra=()):
    out = ["--nerfacto", "--dataset_type", "blender", "--datadir", scene_dir,
           "--no_batching"] + CPU
    for k, v in SMALL.items():
        out += [f"--{k}", str(v)]
    return out + list(extra)


def _setup(scene_dir, extra=(), seed=SEED):
    """(args, scene, cfg, state with the reference's weights, reference
    spec, reference params, sampler)."""
    args = parse_args(_flags(scene_dir, extra))
    scene = load_dataset(args)
    cfg = build_train_config(args, scene)
    state = init_train_state(torch.Generator().manual_seed(0), cfg)
    spec = ref.make_spec(SMALL, len(scene.i_train))
    params = ref.make_params(spec, seed, "cpu", 1e-2)
    leaves = named_leaves(state["params"])
    assert set(leaves) == set(params)
    with torch.no_grad():
        for k, t in leaves.items():
            t.copy_(params[k])
    sample, _ = make_sampler(args, scene, cfg, seed)
    return args, scene, cfg, state, spec, params, sample


def test_contraction_and_spacing_round_trip():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4096, 3), generator=g) * torch.rand((4096, 1),
                                                         generator=g) * 50
    c = intervals.contract(x)
    assert torch.equal(c, ref.contract(x))
    assert torch.all(c.abs() < 2.0)
    inside = x.abs().amax(-1) <= 1
    assert torch.equal(c[inside], x[inside])
    t = torch.cat([torch.rand(1000, generator=g) * 2,
                   torch.rand(1000, generator=g) * 1000])
    s = intervals.spacing(t)
    assert torch.equal(s, ref.s_of(t))
    # s rounds to 2^-24 near 1, and dt/ds = 2 t^2 beyond t = 1: the round
    # trip holds t to 2^-23 t^2 (0.12 at t = 1000) and 1e-6 relative.
    back = intervals.spacing_inv(s)
    assert torch.all((back - t).abs()
                     <= 2.0 ** -23 * t * torch.clamp_min(t, 1.0) + 1e-6 * t)
    near, far = torch.full((5, 1), 0.05), torch.full((5, 1), 1000.0)
    ends = intervals.x_to_t(torch.tensor([[0.0, 1.0]]).expand(5, 2), near, far)
    torch.testing.assert_close(ends, torch.tensor([[0.05, 1000.0]]).expand(5, 2),
                               rtol=2.0 ** -23 * 1000.0, atol=0)
    u = torch.rand((5, 1), generator=g)
    for draw in (None, u):
        e1 = intervals.initial_edges(5, 16, draw)
        assert torch.equal(e1, ref.first_edges(5, 16, draw, "cpu"))
        assert torch.all(e1[:, 1:] >= e1[:, :-1])
        assert torch.equal(intervals.x_to_t(e1, near, far), ref.depths(e1, ref.make_spec({}, 1)))


@pytest.mark.parametrize("anneal", [1.0, 0.37])
def test_pdf_sampler(anneal):
    g = torch.Generator().manual_seed(1)
    n = 64
    edges = torch.sort(torch.rand((n, 17), generator=g), -1).values
    w = torch.rand((n, 16), generator=g) ** 3
    w[:4] = 0.0  # empty rays: the padding alone
    u = torch.rand((n, 1), generator=g)
    for draw in (None, u):
        a = intervals.pdf_edges(edges, w, 8, draw, anneal)
        b = ref.pdf(edges, w, 8, draw, anneal)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
        assert a.shape == (n, 9) and torch.all(a[:, 1:] >= a[:, :-1])
        assert torch.all(a >= edges[:, :1]) and torch.all(a <= edges[:, -1:])


def test_weights_and_background():
    g = torch.Generator().manual_seed(2)
    sigma = torch.rand((32, 12), generator=g) * 5
    delta = torch.rand((32, 12), generator=g)
    a = intervals.interval_weights(sigma, delta)
    torch.testing.assert_close(a, ref.weights_of(sigma, delta), rtol=0,
                               atol=0)
    assert torch.all(a.sum(-1) <= 1.0 + 1e-6)
    alpha = 1 - torch.exp(-sigma * delta)
    prod = torch.cumprod(torch.cat([torch.ones(32, 1), 1 - alpha[:, :-1]], 1), 1)
    torch.testing.assert_close(a, alpha * prod, rtol=1e-5, atol=1e-7)


def test_interlevel_and_distortion():
    g = torch.Generator().manual_seed(3)
    n = 48
    c = torch.sort(torch.rand((n, 9), generator=g), -1).values
    w = torch.rand((n, 8), generator=g) / 8
    props = [torch.sort(torch.rand((n, k + 1), generator=g), -1).values
             for k in (16, 8)]
    pw = [torch.rand((n, k), generator=g) / k for k in (16, 8)]
    a = interlevel_loss(c, w, props, pw)
    b = ref.interlevel(c, w, props, pw)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    assert float(a) > 0
    # A proposal that puts all its mass on every field interval bounds it.
    full = [torch.ones_like(p) for p in pw]
    assert float(interlevel_loss(c, w, props, full)) == 0.0
    torch.testing.assert_close(interval_distortion(c, w), ref.distortion(c, w),
                               rtol=1e-6, atol=0)


def test_update_schedule():
    spec = ref.make_spec({}, 1)
    since, updates = 0, []
    for step in range(7000):
        due = proposal.update_due(step, since)
        assert due == ref.update_due(spec, step, since), step
        updates.append(due)
        since = (0 if due else since) + 1
    assert all(updates[:10])
    late = np.flatnonzero(updates[5200:]) + 5200
    assert set(np.diff(late)) == {6}  # one step in six past the warm-up


def _step_both(scene_dir, since, extra=(), steps=1, seed=SEED):
    args, scene, cfg, state, spec, params, sample = _setup(scene_dir, extra,
                                                           seed)
    state["step"] = state["opt"]["step"] = STEP0
    state["proposal_since"] = since
    gen = torch.Generator().manual_seed(5)
    batches, draws, metrics = [], [], []
    for i in range(steps):
        b = {k: torch.from_numpy(v) for k, v in sample(STEP0 + i + 1).items()}
        d = draw_step(gen, cfg, state["step"], b["rays_o"].shape[0])
        batches.append(b)
        draws.append(d)
        state, m = train_step(state, b, cfg, draws=d)
        metrics.append(m)
        if i == 0:
            grads = {k: v.clone() / 0.1 for k, v in state["opt"]["mu"].items()}
    rparams = {k: v.clone() for k, v in params.items()}
    res = ref.run_steps(rparams, batches, draws, spec, STEP0, STEP0, since)
    return state, metrics, grads, res, rparams, params


def _gaps(state, metrics, grads, res, rparams):
    """The gaps the tolerances of the module docstring bound."""
    leaves = named_leaves(state["params"])
    med = float(np.median(list(res["grad_norms"].values())))
    out = {"loss": abs(float(metrics[0]["loss"]) - res["losses"][0])
           / abs(res["losses"][0]),
           "interlevel": abs(float(metrics[0]["interlevel"])
                             - res["interlevels"][0])
           / max(res["interlevels"][0], 1e-30),
           "grad": max(abs(float(grads[k].norm()) - r) / max(r, med)
                       for k, r in res["grad_norms"].items()),
           "param": max(float(((leaves[k].detach() - rparams[k]).abs()
                               / (1e-5 * rparams[k].abs() + 1e-8)).max())
                        for k in rparams)}
    return out


@pytest.mark.parametrize("since", [6, 1])
def test_step_matches_reference(scene_dir, since):
    """One step from the reference's weights at step 6000: an update step
    (6 steps since the last) and one that leaves the proposals alone."""
    state, metrics, grads, res, rparams, p0 = _step_both(scene_dir, since)
    update = since == 6
    assert res["updates"] == [update]
    assert metrics[0]["proposal_update"] == update
    assert state["proposal_since"] == (1 if update else since + 1)
    gaps = _gaps(state, metrics, grads, res, rparams)
    assert gaps["loss"] <= 1e-6, gaps
    assert gaps["grad"] <= 1e-5, gaps
    assert gaps["param"] <= 1.0, gaps  # 1e-5 relative + 1e-8 (lr 1e-2: 1e-6 of it)
    for k, g in grads.items():
        r = res["grad_norms"][k]
        if k.startswith("proposal_") and not update:
            assert r == 0.0 and float(g.abs().max()) == 0.0
    leaves = named_leaves(state["params"])
    for k in p0:
        moved = not torch.equal(leaves[k].detach(), p0[k])
        if k.startswith("proposal_"):
            assert moved == update, k
            if not update:
                assert float(state["opt"]["nu"][k].abs().max()) == 0.0
    if update:
        assert gaps["interlevel"] <= 1e-5, gaps
        assert res["grad_norms"]["proposal_0.table"] > 0


def test_three_steps_match_reference(scene_dir):
    """Three steps from one update step: the update schedule and the
    moments carried across them."""
    state, metrics, grads, res, rparams, p0 = _step_both(scene_dir, 6,
                                                         steps=3)
    assert res["updates"] == [True, False, False]
    assert [m["proposal_update"] for m in metrics] == res["updates"]
    for m, r in zip(metrics, res["losses"]):
        assert abs(float(m["loss"]) - r) / r <= 1e-6
    # Each leaf's change over the three steps by its norm (the benchmark's
    # change_gap), to 1e-5 of the larger of its own and the median leaf's:
    # a table entry whose gradient is all but zero takes RAdam's near-sign
    # step, so single entries may differ by the step itself.
    leaves = named_leaves(state["params"])
    prog = {k: float((leaves[k].detach() - p0[k]).norm()) for k in p0}
    want = {k: float((rparams[k] - p0[k]).norm()) for k in p0}
    med = float(np.median(list(want.values())))
    for k in p0:
        assert abs(prog[k] - want[k]) <= 1e-5 * max(want[k], med), k


def test_bf16_operands_fail_a_tolerance(scene_dir):
    state, metrics, grads, res, rparams, _ = _step_both(
        scene_dir, 6, extra=["--precision", "bf16"])
    gaps = _gaps(state, metrics, grads, res, rparams)
    assert (gaps["loss"] > 1e-6 or gaps["grad"] > 1e-5
            or gaps["param"] > 1.0), gaps


def test_serve_renders_the_checkpoint(scene_dir, tmp_path):
    """An evaluation render of a written checkpoint through ``serve.build``
    against the reference's evaluation render of the same weights."""
    args, scene, cfg, state, spec, params, _ = _setup(scene_dir)
    state["step"] = 7
    path = save_checkpoint(str(tmp_path), 7, state)
    W, H = 20, 16
    render, step, hw = serve.build(argparse.Namespace(
        width=W, height=H, baked=False,
        train_args=["--"] + _flags(scene_dir, ["--ft_path", path])))
    assert step == 7 and hw == (H, W)
    c2w = np.asarray(scene.poses[scene.i_test[0]], np.float32)[:3, :4]
    maps, _ = render(c2w)
    focal = scene.hwf[2] * (W / scene.hwf[1])
    ro, rd = ref_render.image_rays(H, W, focal, torch.from_numpy(c2w))
    want = ref.render_image(params, ro, rd, spec)
    np.testing.assert_allclose(maps["rgb_map"].reshape(-1, 3),
                               want["rgb"].numpy(), rtol=0, atol=1e-5)
    d = want["depth"].numpy()
    np.testing.assert_allclose(maps["depth_map"].reshape(-1), d, rtol=0,
                               atol=1e-5 * d.mean())
    assert np.all(np.isfinite(maps["disp_map"]))


def test_trainer_and_refusals(scene_dir, tmp_path):
    """``run_nerf``'s trainer trains the preset a few steps and writes a
    checkpoint whose counter resumes; the preset refuses the features it
    does not carry."""
    from indoor_nerf_tpu_torch.train.trainer import train

    base = _flags(scene_dir, ["--expname", "nf", "--basedir", str(tmp_path),
                              "--i_print", "2", "--i_testset", "100",
                              "--i_video", "100", "--i_weights", "100"])
    out = train(parse_args(base + ["--n_iters", "3"]))
    assert out["state"]["proposal_since"] == 1  # steps 0-2 all update
    assert np.all(np.isfinite(out["losses"]))
    again = train(parse_args(base + ["--n_iters", "4"]))
    assert again["state"]["step"] == 4
    for flag in (["--use_occupancy"], ["--N_importance", "8"],
                 ["--use_structural_priors"], ["--use_quantization"],
                 ["--ray_groups", "1,1,1,1"], ["--mesh_shape", "model:2"]):
        with pytest.raises(ValueError, match="--nerfacto refuses"):
            train(parse_args(_flags(scene_dir, flag) + ["--n_iters", "1"]))
