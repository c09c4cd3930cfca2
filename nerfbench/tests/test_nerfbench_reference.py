"""The plain reference against the port at tiny sizes on the CPU: the two
encodes, NeRFSmall with the normal net, the samplers, the compositing, the
structural priors, RAdam and the scene box."""

import dataclasses

import numpy as np
import pytest
import torch

from nerfbench.reference import grid, model, priors, render, step
from nerfbench.reference.spec import blender_bbox, make_spec
from nerfbench import scene

BOX = ((-1.0, -1.2, -0.5), (1.1, 0.9, 1.3))


def _points(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    lo, hi = torch.tensor(BOX[0]), torch.tensor(BOX[1])
    return lo + torch.rand((n, 3), generator=g) * (hi - lo) * 1.1 - 0.05


@pytest.mark.parametrize("io", ["bf16", "f32"])
def test_block_encode_matches_port(io):
    from indoor_nerf_tpu_torch.ops.blockhash import (
        BlockHashConfig, block_hash_encode)

    spec = make_spec({"i_embed": 3, "n_levels": 4, "feats_per_level": 4,
                      "log2_hashmap_size": 12, "finest_res": 40,
                      "block_size": 3, "block_io": io}, BOX)
    cfg = BlockHashConfig(bbox_min=BOX[0], bbox_max=BOX[1], n_levels=4,
                          n_features_per_level=4, log2_rows=spec.log2_rows,
                          finest_resolution=40, block_size=3,
                          gather_dtype="bfloat16" if io == "bf16" else "float32",
                          scatter_dtype="bfloat16" if io == "bf16" else "float32")
    x = _points(500)
    t1 = torch.randn(spec.table_shape, generator=torch.Generator().manual_seed(6),
                     requires_grad=True)
    t2 = t1.detach().clone().requires_grad_(True)
    f1, k1 = grid.block_encode(x, t1, spec)
    f2, k2 = block_hash_encode(x, t2, cfg)
    assert torch.equal(k1, k2)
    torch.testing.assert_close(f1, f2, rtol=0, atol=1e-6)
    w = torch.randn(f1.shape, generator=torch.Generator().manual_seed(7))
    (f1 * w).sum().backward()
    (f2 * w).sum().backward()
    torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-5, atol=1e-6)


def test_hash_encode_matches_port():
    from indoor_nerf_tpu_torch.ops.encoding import HashGridConfig, hash_encode

    spec = make_spec({"i_embed": 1, "n_levels": 5, "log2_hashmap_size": 10,
                      "finest_res": 64}, BOX)
    cfg = HashGridConfig(bbox_min=BOX[0], bbox_max=BOX[1], n_levels=5,
                         log2_hashmap_size=10, finest_resolution=64)
    x = _points(400, 1)
    t1 = torch.randn(spec.table_shape, generator=torch.Generator().manual_seed(8),
                     requires_grad=True)
    t2 = t1.detach().clone().requires_grad_(True)
    f1, _ = grid.hash_encode(x, t1, spec)
    f2, _ = hash_encode(x, t2, cfg)
    torch.testing.assert_close(f1, f2, rtol=0, atol=1e-6)
    f1.square().sum().backward()
    f2.square().sum().backward()
    torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-5, atol=1e-6)


def test_field_matches_nerf_small():
    from indoor_nerf_tpu_torch.models.mlp import init_nerf_small

    spec = make_spec({"i_embed": 3, "n_levels": 8, "feats_per_level": 4,
                      "predict_normals": True}, BOX)
    net = init_nerf_small(torch.Generator().manual_seed(0), input_ch=32,
                          input_ch_views=16, predict_normals=True)
    params = {f"coarse.{k}": v.detach() for k, v in net.named_parameters()}
    assert set(params) == {k for k, _ in model.layer_shapes(spec)[1:]}
    x, v = torch.randn(50, 32), torch.randn(50, 16)
    torch.testing.assert_close(model.field(params, "coarse", x, v, spec),
                               net(x, v), rtol=1e-6, atol=1e-6)


def test_sh_matches_port():
    from indoor_nerf_tpu_torch.ops.encoding import sh_encode

    d = torch.nn.functional.normalize(torch.randn(100, 3), dim=-1)
    torch.testing.assert_close(model.sh_encode(d), sh_encode(d, 4))


def test_samplers_and_composite_match_port():
    from indoor_nerf_tpu_torch.ops.occupancy import OccupancyConfig, occupancy_z_vals
    from indoor_nerf_tpu_torch.ops.sampling import sample_pdf
    from indoor_nerf_tpu_torch.ops.volume import raw2outputs

    spec = make_spec({"i_embed": 3, "use_occupancy": True, "occ_resolution": 8,
                      "occ_candidates": 16, "occ_samples": 6,
                      "occ_weighting": "transmittance"}, BOX)
    oc = OccupancyConfig(bbox_min=BOX[0], bbox_max=BOX[1], resolution=8,
                         n_candidates=16, weighting="transmittance")
    g = torch.Generator().manual_seed(2)
    n = 40
    ro = torch.rand((n, 3), generator=g) * 0.2
    rd = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    near, far = torch.full((n, 1), 0.1), torch.full((n, 1), 2.0)
    density = torch.rand(512, generator=g) * 3
    t_rand = torch.rand((n, 16), generator=g)
    u = (torch.arange(6.0) + torch.rand((n, 6), generator=g)) / 6
    for step_ in (None, 10, 300):
        for tr_, u_ in ((None, None), (t_rand, u)):
            z1 = render.occupancy_z(ro, rd, near, far, density, spec,
                                    step_ is not None and step_ < 256, tr_, u_)
            z2 = occupancy_z_vals(ro, rd, near, far, {"density": density}, oc,
                                  6, step_, t_rand=tr_, u=u_)
            assert torch.equal(z1, z2)
    bins = torch.sort(torch.rand((n, 9), generator=g), -1).values
    w = torch.rand((n, 8), generator=g)
    assert torch.equal(render.sample_pdf(bins, w, 5, None),
                       sample_pdf(bins, w, 5))
    raw = torch.randn((n, 6, 7), generator=g)
    z = torch.sort(torch.rand((n, 6), generator=g) * 4 + 2, -1).values
    a, b = render.composite(raw, z, rd, spec), raw2outputs(raw, z, rd)
    for k1, k2 in (("rgb_map", "rgb_map"), ("depth_map", "depth_map"),
                   ("acc_map", "acc_map"), ("sparsity", "sparsity_loss"),
                   ("normal_map", "normal_map"), ("weights", "weights")):
        torch.testing.assert_close(a[k1], b[k2], rtol=1e-6, atol=1e-6)


def test_priors_match_port():
    from indoor_nerf_tpu_torch.losses.priors import (
        combine_structural_losses, draw_priors)

    g = torch.Generator().manual_seed(3)
    n = 256
    normals = torch.randn((n, 3), generator=g)
    normals[: n // 3] = torch.tensor([0.05, -0.02, 1.0]) + 0.05 * normals[: n // 3]
    normals[n // 3: 2 * n // 3, 2] *= 0.05
    depth = torch.rand(n, generator=g) * 3 + 2
    coords = torch.randint(0, 30, (n, 2), generator=g).float()
    draws = draw_priors(g, n, True)
    w = {"manhattan": 0.5, "planarity": 0.1, "normal_consistency": 0.2}
    want, _ = combine_structural_losses(depth, normals, coords, w, draws)
    got = priors.structural_loss(depth, normals, coords, w, draws)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def test_radam_matches_port():
    from indoor_nerf_tpu_torch.train.optim import (
        exp_decay_lr, init_radam_state, radam_update)

    g = torch.Generator().manual_seed(4)
    p1 = {"table": torch.randn(10, generator=g),
          "coarse.sigma_net.0.w": torch.randn(3, 4, generator=g)}
    p2 = {k: v.clone() for k, v in p1.items()}
    mu = {k: torch.zeros_like(v) for k, v in p1.items()}
    nu = {k: torch.zeros_like(v) for k, v in p1.items()}
    st = init_radam_state(p2)
    st["step"] = 1000
    spec = make_spec({"i_embed": 3, "lrate": 5e-4, "lrate_decay": 500}, BOX)
    for t in range(1001, 1004):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in p1.items()}
        step.radam(p1, grads, mu, nu, t, step.lr_at(spec, t - 1))
        radam_update(p2, grads, st, exp_decay_lr(5e-4, 500, st["step"]))
    for k in p1:
        assert torch.equal(p1[k], p2[k])


def test_scene_box_matches_loader(tmp_path):
    from indoor_nerf_tpu_torch.data.blender import load_blender_data

    root = str(tmp_path / "room")
    scene.write_blender(root, scene.make_room(8, 20, 24))
    *_, hwf, _, box = load_blender_data(root, False, 1)
    mine = blender_bbox(root)
    assert mine[:2] == box and mine[2] == hwf[2]


def test_steps_match_port_step():
    """Three steps of the reference against the port's ``train_step`` on
    the same weights, batches and draws (tiny flagship shapes)."""
    from indoor_nerf_tpu_torch.models.field import FieldConfig
    from indoor_nerf_tpu_torch.ops.blockhash import BlockHashConfig
    from indoor_nerf_tpu_torch.ops.occupancy import OccupancyConfig
    from indoor_nerf_tpu_torch.render.renderer import RenderConfig
    from indoor_nerf_tpu_torch.train.optim import named_leaves
    from indoor_nerf_tpu_torch.train.step import (
        TrainConfig, draw_step, init_train_state, train_step)

    args = {"i_embed": 3, "n_levels": 4, "feats_per_level": 4,
            "log2_hashmap_size": 12, "finest_res": 32, "block_size": 3,
            "block_io": "bf16", "use_occupancy": True, "occ_resolution": 8,
            "occ_candidates": 16, "occ_samples": 6,
            "occ_weighting": "transmittance", "use_viewdirs": True,
            "predict_normals": True, "N_rand": 32, "lrate_decay": 500}
    spec = make_spec(args, BOX)
    bg = BlockHashConfig(bbox_min=BOX[0], bbox_max=BOX[1], n_levels=4,
                         n_features_per_level=4, log2_rows=spec.log2_rows,
                         finest_resolution=32, block_size=3,
                         gather_dtype="bfloat16", scatter_dtype="bfloat16")
    fc = FieldConfig(block_grid=bg, i_embed=3, predict_normals=True)
    oc = OccupancyConfig(bbox_min=BOX[0], bbox_max=BOX[1], resolution=8,
                         n_candidates=16, weighting="transmittance")
    cfg = TrainConfig(render=RenderConfig(field=fc, occupancy=oc,
                                          n_occ_samples=6),
                      n_rand=32, lrate=5e-4, lrate_decay=500, near=2.0, far=6.0)
    st = init_train_state(torch.Generator().manual_seed(0), cfg)
    params = model.make_params(spec, 9, "cpu", 0.3)
    with torch.no_grad():
        for k, t in named_leaves(st["params"]).items():
            t.copy_(params[k])
    st["step"] = st["opt"]["step"] = 1024
    g = torch.Generator().manual_seed(5)
    kept, losses = [], []
    for _ in range(3):
        b = {"rays_o": torch.randn(32, 3, generator=g) * 0.1,
             "rays_d": torch.nn.functional.normalize(
                 torch.randn(32, 3, generator=g), dim=-1),
             "target": torch.rand(32, 3, generator=g)}
        d = draw_step(g, cfg, st["step"], 32)
        st, m = train_step(st, b, cfg, draws=d)
        kept.append((b, d))
        losses.append(float(m["loss"]))
    ref = step.run_steps(params, [b for b, _ in kept], [d for _, d in kept],
                         spec, 1024, 1024, torch.ones(512))
    np.testing.assert_allclose(ref["losses"], losses, rtol=1e-6)
    for k, t in named_leaves(st["params"]).items():
        torch.testing.assert_close(params[k], t.detach(), rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(ref["density"], st["occ"]["density"])
    assert dataclasses.is_dataclass(spec)


def test_tf32_rounding_of_the_control():
    x = torch.randn(100000, generator=torch.Generator().manual_seed(9)) * 100
    r = model._RoundTF32.apply(x)
    rel = ((r - x).abs() / x.abs()).max().item()
    assert 0 < rel <= 2.0 ** -11
    assert torch.equal(model._RoundTF32.apply(r), r)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
