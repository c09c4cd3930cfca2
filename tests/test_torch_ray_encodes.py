"""Port parity: the ray-structured encodes (``ray_groups``, ``ray_strides``)
against the JAX package, from their coordinates up to a training step and
a render.

Samples are ray-structured and sorted along each ray, as the renderer
makes them. The JAX encode backward runs its Pallas scatters in interpret
mode (``_FORCE_PALLAS_SCATTER_INTERPRET``): the f32-accumulating path the
TPU runs, and the port's numerics.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indoor_nerf_tpu.ops.blockhash as jbh
from _torch_parity import (
    CPU,
    TINY_FLAGSHIP,
    both_states,
    check_train_step_matches_jax,
    configs,
)
from indoor_nerf_tpu.render.renderer import render_image as j_render_image
from indoor_nerf_tpu_torch import serve
from indoor_nerf_tpu_torch.data.poses import pose_spherical
from indoor_nerf_tpu_torch.ops import blockhash as tbh
from indoor_nerf_tpu_torch.render.renderer import render_image
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.train.trainer import train

torch.set_num_threads(1)

T = torch.from_numpy
_GEOM = dict(bbox_min=(-1.0, -1.2, -0.8), bbox_max=(1.1, 1.0, 1.3),
             n_levels=4, n_features_per_level=4, log2_rows=7,
             base_resolution=4, finest_resolution=32, block_size=3)


@pytest.fixture
def f32_scatter(monkeypatch):
    """The JAX fused backward through its f32-accumulating Pallas kernels."""
    monkeypatch.setattr(jbh, "_FORCE_PALLAS_SCATTER_INTERPRET", True)


def _configs(dtype="bfloat16", **kw):
    geom = dict(_GEOM, gather_dtype=dtype, scatter_dtype=dtype, **kw)
    return jbh.BlockHashConfig(**geom), tbh.BlockHashConfig(**geom)


def _ray_pts(rng, n_rays, n_samples):
    """Sorted samples along random rays; some leave the bbox."""
    o = rng.uniform(-0.9, 0.9, size=(n_rays, 1, 3))
    d = rng.standard_normal((n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(0.0, 0.8, size=(n_rays, n_samples, 1)), axis=1)
    return (o + t * d).astype(np.float32)


def _grouped_coords(x3, cfg, groups):
    """The port's anchor coordinates of ``[Rn, S, 3]`` samples."""
    Rn, S, _ = x3.shape
    L = cfg.n_levels
    v0, w, level_ids, _ = tbh._vertex_coords(x3.reshape(-1, 3), cfg,
                                             np.arange(L))
    return tbh._grouped_coords(v0.reshape(Rn, S, L, 3), w.reshape(Rn, S, L, 3),
                               level_ids, cfg, groups)


def _table(rng, cfg):
    shape = (cfg.n_levels * cfg.rows_per_level,
             cfg.n_features_per_level * cfg.lanes_per_feature)
    return rng.standard_normal(shape).astype(np.float32)


def test_level_subset_tile_coords_match_jax(rng):
    jcfg, tcfg = _configs()
    x = _ray_pts(rng, 64, 4).reshape(-1, 3)
    for levels in ((2, 3), (0,), (1, 2, 3)):
        j_row, j_p, j_keep = jbh._tile_coords(jnp.asarray(x), jcfg, levels)
        t_row, t_p, t_keep = tbh._tile_coords(T(x), tcfg, levels)
        np.testing.assert_array_equal(t_row.numpy(), np.asarray(j_row))
        np.testing.assert_array_equal(t_p.numpy(), np.asarray(j_p))
        np.testing.assert_array_equal(t_keep.numpy(), np.asarray(j_keep))


@pytest.mark.parametrize("groups,S", [
    ((4, 4, 2, 1), 8), ((3, 3, 2, 1), 8), ((4, 4, 4, 4), 6), ((1, 2, 2, 1), 4)])
def test_grouped_classes_match_jax(groups, S):
    jcfg, tcfg = _configs(ray_groups=groups)
    assert tbh._grouped_classes(tcfg, S) == jbh._grouped_classes(jcfg, S)


def test_anchor_coords_at_g1_are_tile_coords(rng):
    """Bit for bit: at G = 1 the anchor is the sample's own vertex and the
    clip to [0, B] changes nothing."""
    _, tcfg = _configs()
    x3 = T(_ray_pts(rng, 32, 6))
    row, p = _grouped_coords(x3, tcfg, (1, 1, 1, 1))
    t_row, t_p, _ = tbh._tile_coords(x3.reshape(-1, 3), tcfg)
    assert row.dtype == torch.int32 and row.shape == (32, 6, 4)
    np.testing.assert_array_equal(row.reshape(-1).numpy(), t_row.numpy())
    np.testing.assert_array_equal(p.reshape(-1, 3).numpy(), t_p.numpy())


def test_anchor_coords_match_jax(rng):
    """Each class's anchor rows and clipped in-tile positions are the JAX
    ``_grouped_coords`` ones, exactly (the same f32 op order)."""
    groups = (4, 4, 2, 1)
    jcfg, tcfg = _configs(ray_groups=groups)
    x3 = _ray_pts(rng, 40, 8)
    row, p = _grouped_coords(T(x3), tcfg, groups)
    Rn, S = x3.shape[:2]
    straddled = 0
    for G, lv in jbh._grouped_classes(jcfg, S):
        j_row, j_p = jbh._grouped_coords(jnp.asarray(x3), jcfg, lv, G)
        sel = list(lv)
        np.testing.assert_array_equal(row[:, ::G, sel].reshape(-1).numpy(),
                                      np.asarray(j_row))
        want_p = np.asarray(j_p).reshape(Rn, S, len(lv), 3)
        np.testing.assert_array_equal(p[:, :, sel].numpy(), want_p)
        # every member carries its group's anchor row
        r = row[:, :, sel].reshape(Rn, S // G, G, len(lv))
        assert torch.equal(r, r[:, :, :1].expand_as(r))
        straddled += int(((want_p == 0.0) | (want_p == jcfg.block_size)).sum())
    assert straddled > 0  # some members left their anchor's block


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("groups", [
    (2, 2, 1, 1),  # two classes: the ragged kernel
    (2, 2, 2, 2),  # one class: JAX's scatter_add_table route
    (4, 4, 2, 1),  # three classes
    (3, 2, 2, 1),  # 3 does not divide S = 8: level 0 demotes to 1
])
def test_grouped_encode_gradient_matches_jax(rng, f32_scatter, groups, dtype):
    """d table of <feats, c> for a fixed cotangent c. Both sides form the
    same group sums (members summed in f32 in member order) and the same
    rounding; the table's f32 sums run in other orders: 1e-5."""
    jcfg, tcfg = _configs(dtype, ray_groups=groups)
    x3 = _ray_pts(rng, 24, 8)
    table = _table(rng, tcfg)
    c = rng.standard_normal((24, 8, tcfg.out_dim)).astype(np.float32)

    want = jax.grad(lambda t: jnp.sum(
        jbh.block_hash_encode_grouped(jnp.asarray(x3), t, jcfg)[0] * c))(
            jnp.asarray(table))
    tt = T(table).requires_grad_(True)
    feats, keep = tbh.block_hash_encode_grouped(T(x3), tt, tcfg)
    (got,) = torch.autograd.grad(feats, tt, grad_outputs=T(c))
    assert got.dtype == torch.float32 and got.shape == tt.shape
    assert keep.shape == (24, 8) and not bool(keep.all())
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_grouped_stream_replays_the_step_call():
    """``path_streams.grouped_stream`` hands back the arguments of the one
    ``grouped_scatter`` call a grouped step's backward makes: the step's
    cotangent and the forward's lattice coordinates, which give the same
    table gradient again, through the anchor coordinates or directly."""
    from indoor_nerf_tpu_torch.ops.group_scatter import group_scatter
    from indoor_nerf_tpu_torch.path_streams import grouped_stream

    flags = TINY_FLAGSHIP + CPU + ["--ray_groups", "2,2,1,1", "--N_rand", "64"]
    args = grouped_stream(torch.device("cpu"), flags)
    g, v0, w, level_ids, cfg, groups, n_rows = args
    S, L, F = 8, 4, cfg.n_features_per_level  # TINY_FLAGSHIP: 8 samples
    assert groups == (2, 2, 1, 1) and cfg.ray_groups == groups
    assert g.shape == (64, S, L * F) and g.dtype == torch.float32
    assert v0.shape == w.shape == (64, S, L, 3)
    assert (v0.dtype, w.dtype) == (torch.int32, torch.float32)
    assert level_ids.tolist() == [0, 1, 2, 3]
    assert n_rows == L * cfg.rows_per_level
    grad = tbh.grouped_scatter(*args)
    assert grad.shape == (n_rows, F * cfg.lanes_per_feature)
    assert float(grad.abs().max()) > 0.0 and bool(torch.isfinite(grad).all())
    row, p = tbh._grouped_coords(v0, w, level_ids, cfg, groups)
    np.testing.assert_array_equal(
        grad.numpy(),
        group_scatter(g, row, p, groups, n_rows, cfg.side,
                      cfg.lanes_per_feature, cfg.torch_scatter_dtype).numpy())


def test_grouped_forward_is_the_plain_encode(rng):
    """The features are bit for bit the flat encode's, groups straddling
    blocks included; the points get no gradient, at float32 too (the JAX
    grouped VJP returns a zero dx at both scatter dtypes)."""
    _, tcfg = _configs("float32", ray_groups=(4, 4, 2, 1))
    _, flat = _configs("float32")
    x3 = T(_ray_pts(rng, 16, 8)).requires_grad_(True)
    table = T(_table(rng, tcfg)).requires_grad_(True)
    fg, kg = tbh.block_hash_encode_grouped(x3, table, tcfg)
    with torch.no_grad():
        f0, k0 = tbh.block_hash_encode(x3.reshape(-1, 3), table, flat)
    np.testing.assert_array_equal(fg.detach().reshape(-1, 16).numpy(), f0.numpy())
    np.testing.assert_array_equal(kg.reshape(-1).numpy(), k0.numpy())
    fg.sum().backward()
    assert x3.grad is None and float(table.grad.abs().max()) > 0.0


def test_all_g1_routes_to_the_plain_encode(rng):
    _, tcfg = _configs(ray_groups=(4, 4, 4, 4))  # none divides S = 6
    _, flat = _configs()
    x3 = T(_ray_pts(rng, 8, 6))
    table = T(_table(rng, tcfg)).requires_grad_(True)
    fg, _ = tbh.block_hash_encode_grouped(x3, table, tcfg)
    f0, _ = tbh.block_hash_encode(x3.reshape(-1, 3), table, flat)
    np.testing.assert_array_equal(fg.detach().reshape(-1, 16).numpy(),
                                  f0.detach().numpy())
    (g1,) = torch.autograd.grad(fg.sum(), table)
    (g0,) = torch.autograd.grad(f0.sum(), table)
    np.testing.assert_array_equal(g1.numpy(), g0.numpy())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_strided_encode_matches_jax(rng, f32_scatter, dtype):
    """Features: the knot encodes and the arc-length lerp in f32, summed in
    other orders: 1e-5. Table gradient: the lerp's transpose sums each
    knot's cotangent in another order, one f32 ulp apart, and at bf16 such
    a cotangent can round to the neighbouring bf16 value, moving that
    entry by one bf16 ulp (2^-8) of one term: 2^-8 of the largest entry,
    and 1e-3 relative in norm. At f32, 1e-5."""
    strides = (4, 4, 2, 1)
    jcfg, tcfg = _configs(dtype, ray_strides=strides)
    x3 = _ray_pts(rng, 24, 9)
    table = _table(rng, tcfg)
    c = rng.standard_normal((24, 9, tcfg.out_dim)).astype(np.float32)

    want, want_keep = jbh.block_hash_encode_strided(
        jnp.asarray(x3), jnp.asarray(table), jcfg)
    want_g = np.asarray(jax.grad(lambda t: jnp.sum(
        jbh.block_hash_encode_strided(jnp.asarray(x3), t, jcfg)[0] * c))(
            jnp.asarray(table)))
    tt = T(table).requires_grad_(True)
    got, keep = tbh.block_hash_encode_strided(T(x3), tt, tcfg)
    (got_g,) = torch.autograd.grad(got, tt, grad_outputs=T(c))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    scale = float(np.abs(want_g).max())
    assert scale > 0.1
    if dtype == "float32":
        np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0,
                                   atol=2.0 ** -8 * scale)
        assert np.linalg.norm(got_g.numpy() - want_g) <= \
            1e-3 * np.linalg.norm(want_g)


def test_stride_knots_match_jax():
    for S, k in [(32, 4), (9, 2), (8, 3), (1, 2), (5, 8)]:
        ks = tbh._at_knots(torch.arange(S)[None], k)[0]
        np.testing.assert_array_equal(ks.numpy(), jbh._stride_knots(S, k)[0])


@pytest.mark.parametrize("flag", [["--ray_groups", "2,2,1,1"],
                                  ["--ray_strides", "2,2,1,1"]])
def test_ray_structured_train_step_matches_jax(f32_scatter, flag):
    """One flagship step (tiny size, 8 samples per ray) with each
    ray-structured encode, at the tolerances of
    ``test_train_step_matches_jax``. With ``--ray_groups 2,2,1,1`` the JAX
    backward is one ragged Pallas call over two classes."""
    _, tcfg, _ = configs(TINY_FLAGSHIP + flag)
    bg = tcfg.render.field.block_grid
    assert (bg.ray_groups or bg.ray_strides) == (2, 2, 1, 1)
    check_train_step_matches_jax(TINY_FLAGSHIP + flag)


def test_strided_render_matches_jax(rng):
    """A tiny flagship render with ``--ray_strides 2,2,1,1`` on bridged
    weights, at the tolerances of ``test_render_image_matches_jax``."""
    jcfg, tcfg, scene = configs(TINY_FLAGSHIP + ["--ray_strides", "2,2,1,1"])
    jstate, tstate = both_states(jcfg, occ_rng=rng)
    table = 5.0 * rng.standard_normal(jstate["params"]["table"].shape)
    jstate["params"]["table"] = jnp.asarray(table, jnp.float32)
    tstate["params"]["table"] = T(table.astype(np.float32))
    H = W = 24
    focal = scene.hwf[2] * (W / scene.hwf[1])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    c2w = scene.poses[scene.i_test[0]][:3, :4]
    want = j_render_image(jstate["params"], H, W, K, c2w, scene.near,
                          scene.far, jcfg.render, tile_rays=256,
                          occ_state=jstate["occ"])
    got = render_image(tstate["params"], H, W, K, c2w, scene.near, scene.far,
                       tcfg.render, tile_rays=256, occ_state=tstate["occ"])
    assert want["acc_map"].max() > 0.5  # the field is not transparent
    for k in ("rgb_map", "acc_map"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3, err_msg=k)
    seen = want["acc_map"] > 1e-3
    np.testing.assert_allclose(got["depth_map"][seen], want["depth_map"][seen],
                               rtol=0, atol=1e-3)


def _serve_rgb(flags):
    args = argparse.Namespace(width=12, height=10,
                              train_args=["--"] + flags + CPU)
    render, _, _ = serve.build(args)
    maps, _ = render(pose_spherical(30.0, -30.0, 4.0))
    assert maps["rgb_map"].shape == (10, 12, 3)
    assert np.all(np.isfinite(maps["rgb_map"]))
    return maps["rgb_map"]


def test_serve_builds_and_renders_ray_structured_configs():
    """``--ray_groups`` changes only the backward, so the served image is
    the plain one; ``--ray_strides`` lerps the coarse levels, so it builds
    and renders its own."""
    plain = _serve_rgb(TINY_FLAGSHIP)
    np.testing.assert_array_equal(
        _serve_rgb(TINY_FLAGSHIP + ["--ray_groups", "2,2,1,1"]), plain)
    _serve_rgb(TINY_FLAGSHIP + ["--ray_strides", "2,2,1,1"])


@pytest.mark.parametrize("flag", [["--ray_groups", "2,2,1,1"],
                                  ["--ray_strides", "2,2,1,1"]])
def test_trainer_runs_ray_structured_cli(flag):
    args = parse_args(TINY_FLAGSHIP + CPU + flag + [
        "--N_rand", "64", "--n_iters", "8", "--i_print", "4", "--lrate", "0.01"])
    out = train(args)
    assert len(out["losses"]) == 8 and np.all(np.isfinite(out["losses"]))
    assert out["state"]["step"] == 8


def test_trainer_refuses_both_ray_flags():
    args = parse_args(TINY_FLAGSHIP + CPU + ["--ray_groups", "2,2,1,1",
                                       "--ray_strides", "2,2,1,1",
                                       "--n_iters", "1"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        train(args)
    with pytest.raises(ValueError, match="4 positive ints"):
        train(parse_args(TINY_FLAGSHIP + CPU + ["--ray_groups", "2,1",
                                                "--n_iters", "1"]))
