"""The port's baked renderer (render/baked.py) against the JAX package's on
the same numpy inputs and the same params through ``bridge``.

Sizes as tests/test_baked.py::_tiny_field: 4 levels, log2_rows 6, bakes at
resolution 8 or 16. The table is scaled to O(1) entries so that the rays
are not transparent. Renders are compared on the SAME baked tables (the JAX
bake, moved across with ``bridge.baked_from_numpy``), so that a vertex whose
bf16 or int8 rounding falls the other way in the two bakes does not leak
into the render comparison; the bakes themselves are compared table by
table.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indoor_nerf_tpu.models.field import FieldConfig as JFieldConfig
from indoor_nerf_tpu.models.field import init_field_params as j_init_field_params
from indoor_nerf_tpu.ops.blockhash import BlockHashConfig as JBlockHashConfig
from indoor_nerf_tpu.render import baked as jb
from indoor_nerf_tpu_torch.bridge import (
    baked_from_numpy,
    baked_to_numpy,
    params_from_numpy,
)
from indoor_nerf_tpu_torch.models.field import FieldConfig, sigma_query
from indoor_nerf_tpu_torch.ops.blockhash import BlockHashConfig
from indoor_nerf_tpu_torch.render import baked as tb

torch.set_num_threads(1)

BBOX = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
GRID = dict(n_levels=4, log2_rows=6, base_resolution=8, finest_resolution=32)
T = torch.from_numpy


@functools.lru_cache(maxsize=None)
def fields(bbox=BBOX):
    """(JAX field config, JAX params, port field config, port params)
    holding the same weights."""
    jfc = JFieldConfig(block_grid=JBlockHashConfig(
        bbox_min=bbox[0], bbox_max=bbox[1], **GRID), i_embed=3, n_importance=0)
    jparams = j_init_field_params(jax.random.PRNGKey(0), jfc)
    jparams["table"] = jparams["table"] * 3e4  # O(1) features
    tfc = FieldConfig(block_grid=BlockHashConfig(
        bbox_min=bbox[0], bbox_max=bbox[1], **GRID), i_embed=3, n_importance=0)
    tree = {"params": jax.tree_util.tree_map(np.asarray, jparams), "occ": None}
    return jfc, jparams, tfc, params_from_numpy(tree)["params"]


def cameras(n=2, H=16, W=16):
    """Two views with a narrow field of view from one side of the box, so
    that part of it is seen by no ray."""
    poses = []
    for th in np.linspace(0.0, 0.5, n):
        c, s = np.cos(th), np.sin(th)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        poses.append(np.concatenate([rot, rot @ np.array([[0.0], [0.0], [3.0]],
                                                        np.float32)], axis=1))
    K = np.array([[36.0, 0, W / 2], [0, 36.0, H / 2], [0, 0, 1]], np.float32)
    return {"poses": np.stack(poses), "K": K, "H": H, "W": W, "near": 1.0,
            "far": 5.0}


@functools.lru_cache(maxsize=None)
def jax_bake(table_dtype="float32", sigma_enc="sqrt", geo_resolution=-1,
             resolution=8, bbox=BBOX, with_cameras=False, clip=100.0):
    jfc, jparams, _, _ = fields(bbox)
    return jb.bake_field(jparams, jfc, resolution=resolution,
                         table_dtype=table_dtype, blocks_per_chunk=8,
                         geo_resolution=geo_resolution, sigma_enc=sigma_enc,
                         int8_clip_pct=clip,
                         train_cameras=cameras() if with_cameras else None,
                         vis_subsample=2)


def port_bake(table_dtype="float32", sigma_enc="sqrt", geo_resolution=-1,
              resolution=8, bbox=BBOX, with_cameras=False, clip=100.0):
    _, _, tfc, tparams = fields(bbox)
    return tb.bake_field(tparams, tfc, resolution=resolution,
                         table_dtype=table_dtype, blocks_per_chunk=8,
                         geo_resolution=geo_resolution, sigma_enc=sigma_enc,
                         int8_clip_pct=clip,
                         train_cameras=cameras() if with_cameras else None,
                         vis_subsample=2)


def crossed(jbaked):
    """A JAX snapshot as the port's, through numpy."""
    tree = {k: jax.tree_util.tree_map(np.asarray, v)
            for k, v in jbaked.items() if k != "config"}
    tree["config"] = dataclasses.asdict(jbaked["config"])
    return baked_from_numpy(tree)


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def rays(n=96, seed=3):
    rng = np.random.default_rng(seed)
    o = np.tile([[0.0, 0.0, -3.0]], (n, 1)) + 0.1 * rng.standard_normal((n, 3))
    d = np.stack([np.linspace(-0.4, 0.4, n), 0.2 * rng.standard_normal(n),
                  np.ones(n)], axis=-1)
    d[5, 0] = 0.0  # an axis-parallel component: the 1e-9 guard of _ray_aabb
    d[-1] = [0.0, 3.0, 1.0]  # a ray that misses the box
    o, d = o.astype(np.float32), d.astype(np.float32)
    return o, d, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_constants_and_config_match_jax():
    assert (tb.BLOCK, tb.SIDE, tb.LANES) == (jb.BLOCK, jb.SIDE, jb.LANES)
    want = [(f.name, f.default) for f in dataclasses.fields(jb.BakedConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(tb.BakedConfig)]
    assert got == want
    kw = dict(bbox_min=BBOX[0], bbox_max=BBOX[1], resolution=16,
              table_dtype="int8sig", geo_resolution=4)
    j, t = jb.BakedConfig(**kw), tb.BakedConfig(**kw)
    for prop in ("blocks_per_edge", "n_blocks", "geo_res", "sigma_quantized",
                 "geo_quantized"):
        assert getattr(t, prop) == getattr(j, prop), prop


def test_ray_aabb_matches_jax():
    o, d, _ = rays()
    bmin, bmax = np.float32(BBOX[0]), np.float32(BBOX[1])
    want = jb._ray_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(bmin),
                        jnp.asarray(bmax), 0.5, 6.0)
    got = tb._ray_aabb(T(o), T(d), T(bmin), T(bmax), 0.5, 6.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[1][-1]) <= float(got[0][-1])  # the miss: empty interval


@pytest.mark.parametrize("dtype,n_features,tol", [
    ("float32", 1, 1e-6), ("float32", 2, 1e-6), ("bfloat16", 1, 1e-6),
    ("bfloat16", 2, 1e-6), ("int8", 1, 1e-6)])
def test_tent_interp_matches_jax(dtype, n_features, tol):
    """Same rows, same positions (integers and the top face included);
    f32 sums of the same products in another order: 1e-6 relative to the
    largest output."""
    rng = np.random.default_rng(1)
    m = 300
    p = (rng.random((m, 3)) * 4).astype(np.float32)
    p[:20] = rng.integers(0, 5, (20, 3))
    if dtype == "int8":
        rows = rng.integers(-127, 128, (m, n_features * 128)).astype(np.int8)
        jrows, trows = jnp.asarray(rows), T(rows)
    else:
        rows = rng.standard_normal((m, n_features * 128)).astype(np.float32)
        jrows = jnp.asarray(rows).astype(jnp.dtype(dtype))
        trows = T(rows).to(getattr(torch, dtype))
    want = np.asarray(jb._tent_interp(jrows, *(jnp.asarray(p[:, a]) for a in range(3)),
                                      n_features))
    got = tb._tent_interp(trows, *(T(p[:, a].copy()) for a in range(3)),
                          n_features).numpy()
    assert got.shape == (m, n_features) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_sigma_geo_query_matches_jax():
    jfc, jparams, tfc, tparams = fields()
    rng = np.random.default_rng(2)
    pts = (rng.random((200, 3)) * 2.4 - 1.2).astype(np.float32)  # some outside
    ws, wg = jb._sigma_geo_query(jparams, jfc, "coarse", jnp.asarray(pts))
    with torch.no_grad():
        gs, gg = sigma_query(tparams, "coarse", T(pts), tfc, with_geo=True)
    assert np.any(np.asarray(ws) == 0) and np.abs(np.asarray(ws)).max() > 0.1
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gg.numpy(), np.asarray(wg), rtol=1e-5, atol=1e-5)


def assert_tables_match(got, want, table_dtype):
    """A port bake against a JAX bake, table by table. float32: 1e-5 of the
    table's largest entry. bfloat16: the two sweeps differ by f32 ulps before
    the rounding, so an entry may fall to the neighbouring bfloat16 (2^-7
    relative), rarely. int8: likewise one level, rarely."""
    assert got["config"] == tb.BakedConfig(**dataclasses.asdict(want["config"]))
    g = baked_to_numpy(got)
    quantized = {"sigma_table": want["config"].sigma_quantized,
                 "voxel_geo": want["config"].geo_quantized}
    for key in ("sigma_table", "voxel_geo"):
        w = f32(want[key])
        assert g[key].shape == w.shape, key
        assert str(got[key].dtype).endswith(str(want[key].dtype)), key
        diff = np.abs(g[key].astype(np.float32) - w)
        if quantized[key]:
            assert diff.max() <= 1, key
            assert (diff > 0).mean() < 0.01, key
        elif table_dtype == "float32":
            assert diff.max() <= 1e-5 * np.abs(w).max(), key
        else:
            assert np.all(diff <= 2.0 ** -7 * np.abs(w) + 1e-30), key
            assert (diff > 0).mean() < 0.01, key
    np.testing.assert_allclose(g["block_max"], f32(want["block_max"]),
                               rtol=2.0 ** -6, atol=1e-6)
    for key in ("sigma_scale", "geo_scale"):
        assert (key in got) == (key in want), key
        if key in want:
            np.testing.assert_allclose(g[key], f32(want[key]), rtol=1e-5)
    for lg, lw in zip(g["color_net"], want["color_net"]):
        np.testing.assert_array_equal(lg["w"], np.asarray(lw["w"]))


@pytest.mark.parametrize("table_dtype,sigma_enc", [
    ("float32", "sqrt"), ("bfloat16", "sqrt"), ("int8", "sqrt"),
    ("int8", "log1p"), ("int8sig", "sqrt"), ("int8sig", "log1p"),
    ("int8geo", "sqrt")])
def test_bake_field_tables_match_jax(table_dtype, sigma_enc):
    kw = dict(table_dtype=table_dtype, sigma_enc=sigma_enc)
    assert_tables_match(port_bake(**kw), jax_bake(**kw), table_dtype)


@pytest.mark.parametrize("geo_resolution,rows", [(0, 8 ** 3), (-1, 4 ** 3),
                                                 (2, 2 ** 3)])
def test_bake_field_geo_resolution_matches_jax(geo_resolution, rows):
    got = port_bake(geo_resolution=geo_resolution)
    assert got["voxel_geo"].shape == (rows, 128)
    assert_tables_match(got, jax_bake(geo_resolution=geo_resolution), "float32")


def test_bake_field_at_resolution_16_in_several_chunks():
    """Chunks of 8 * 128 points over 17^3 vertices: a short last chunk."""
    kw = dict(resolution=16, table_dtype="float32")
    assert_tables_match(port_bake(**kw), jax_bake(**kw), "float32")


def test_bake_field_clip_percentile_matches_jax():
    kw = dict(table_dtype="int8geo", clip=99.0, resolution=16)
    got, want = port_bake(**kw), jax_bake(**kw)
    assert_tables_match(got, want, "int8geo")
    full = port_bake(table_dtype="int8geo", resolution=16)
    assert torch.all(got["geo_scale"] <= full["geo_scale"] + 1e-12)
    assert torch.any(got["geo_scale"] < full["geo_scale"])


@pytest.mark.parametrize("pct", [50.0, 99.0, 99.9])
def test_percentile_is_numpys(pct):
    x = np.abs(np.random.default_rng(4).standard_normal((4913, 5))
               ).astype(np.float32)
    np.testing.assert_allclose(tb._percentile(T(x), pct).numpy(),
                               np.percentile(x, pct, axis=0), rtol=1e-6)


def test_visibility_mask_matches_jax():
    """Equal as a bool array: the weights that decide a cell are far from
    the 1e-3 threshold at this size (a cell kept by one ray alone has a
    weight of that ray's order, ~0.1)."""
    jfc, jparams, tfc, tparams = fields()
    bmin, bmax = np.float32(BBOX[0]), np.float32(BBOX[1])
    cams = cameras()
    want = np.asarray(jb._visibility_mask(jparams, jfc, "coarse", 8, bmin, bmax,
                                          cams, subsample=2))
    with torch.no_grad():
        got = tb._visibility_mask(tparams, tfc, "coarse", 8, bmin, bmax, cams,
                                  subsample=2).numpy()
    assert got.shape == (9 ** 3,) and got.dtype == np.bool_
    assert 0 < want.sum() < want.size  # it culls, and not everything
    np.testing.assert_array_equal(got, want)


def test_bake_field_with_cameras_matches_jax():
    got, want = port_bake(with_cameras=True), jax_bake(with_cameras=True)
    assert float(got["sigma_table"].min()) < -1e3  # the -1e4 sentinel
    assert_tables_match(got, want, "float32")


RENDER_KEYS = ("rgb_map", "depth_map", "acc_map", "disp_map", "t_lo", "t_hi")


@pytest.mark.parametrize("corner_matmul", [True, False])
@pytest.mark.parametrize("k_geo,bounded,renorm_k", [
    (4, False, True), (None, False, True), (4, True, True), (2, True, False)])
@pytest.mark.parametrize("table_dtype,rtol,atol", [
    ("float32", 1e-4, 1e-5), ("int8", 1e-4, 1e-5), ("bfloat16", 2e-2, 2e-3)])
def test_baked_render_rays_matches_jax(table_dtype, rtol, atol, k_geo, bounded,
                                       renorm_k, corner_matmul):
    """All six outputs against both pass-2 forms of the JAX renderer, at the
    tolerances the JAX tests hold its two forms to each other
    (tests/test_baked.py:88-135). disp is 1 / depth, held at 10x."""
    jbaked = jax_bake(table_dtype=table_dtype)
    tbaked = crossed(jbaked)
    o, d, vd = rays()
    n, S = o.shape[0], 24
    tbnd = jbnd = None
    if bounded:
        lo = np.linspace(1.5, 2.5, n).astype(np.float32)
        hi = lo + np.float32(1.0)
        hi[:4] = lo[:4] - 1.0  # disjoint from the box: the full interval
        jbnd, tbnd = (jnp.asarray(lo), jnp.asarray(hi)), (T(lo), T(hi))
    want = jb.baked_render_rays(
        jbaked, jnp.asarray(o), jnp.asarray(d), jnp.asarray(vd), 0.5, 6.0,
        n_samples=S, k_geo=k_geo, t_bounds=jbnd, corner_matmul=corner_matmul,
        renorm_k=renorm_k)
    with torch.no_grad():
        got = tb.baked_render_rays(tbaked, T(o), T(d), T(vd), 0.5, 6.0,
                                   n_samples=S, k_geo=k_geo, t_bounds=tbnd,
                                   renorm_k=renorm_k)
    assert set(got) == set(RENDER_KEYS)
    acc = np.asarray(want["acc_map"])
    assert acc.max() > 0.5 and acc.min() < 0.1  # opaque and clear rays
    for key in RENDER_KEYS:
        scale = 10.0 if key == "disp_map" else 1.0
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=scale * rtol, atol=scale * atol,
                                   err_msg=key)


def image_setup(H, W):
    K = np.array([[14.0, 0, W / 2], [0, 14.0, H / 2], [0, 0, 1]], np.float32)
    c2w = np.concatenate([np.eye(3, dtype=np.float32),
                          np.array([[0.0], [0.0], [3.5]], np.float32)], axis=1)
    c2w2 = c2w.copy()
    c2w2[:, 3] = [0.4, -0.2, 3.2]
    return K, c2w, np.stack([c2w, c2w2])


@pytest.mark.parametrize("block", [False, True], ids=["pose", "pose_block"])
@pytest.mark.parametrize("guided", [0, 4], ids=["unguided", "guided4"])
def test_image_renderer_matches_jax(guided, block):
    """Full images at a resolution that 4 does not divide (11 x 13), as
    tests/test_baked.py::test_guided_render_non_divisible_resolution, in
    tiles that do not divide the ray count. Guided: the fine pass's interval
    comes from the coarse pass's t_lo / t_hi, which are sample depths, so a
    ulp in a cumulative weight next to 2% or 98% of acc moves a bound by a
    whole coarse step; none does at this size, and rgb stays within 1e-4."""
    bbox = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
    jbaked = jax_bake(bbox=bbox)
    tbaked = crossed(jbaked)
    H, W = 11, 13
    K, c2w, c2ws = image_setup(H, W)
    kw = dict(n_samples=16 if guided else 32, guided=guided, n_coarse=32)
    pose = c2ws if block else c2w
    want = jb.make_baked_image_renderer(jbaked, H, W, tile_rays=512, **kw)(
        pose, K, 2.0, 6.0)
    render = tb.make_baked_image_renderer(tbaked, H, W, tile_rays=50, **kw)
    assert render.pose_block == 4
    got = render(pose, K, 2.0, 6.0)
    lead = (2,) if block else ()
    assert got["rgb_map"].shape == lead + (H, W, 3)
    assert np.asarray(want["acc_map"]).max() > 0.5
    for key in ("rgb_map", "depth_map", "acc_map"):
        assert got[key].shape == np.asarray(want[key]).shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_guided_render_stays_close_to_unguided():
    """The port's own guided render against its own 64-sample march, as the
    JAX test bounds it (mean |diff| < 0.1)."""
    tbaked = port_bake(bbox=((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5)))
    H, W = 11, 13
    K, c2w, _ = image_setup(H, W)
    out = tb.make_baked_image_renderer(tbaked, H, W, n_samples=16, guided=4,
                                       n_coarse=32)(c2w, K, 2.0, 6.0)
    ref = tb.make_baked_image_renderer(tbaked, H, W, n_samples=64)(
        c2w, K, 2.0, 6.0)
    assert torch.isfinite(out["rgb_map"]).all()
    assert float((out["rgb_map"] - ref["rgb_map"]).abs().mean()) < 0.1


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_snapshot_round_trip(tmp_path, table_dtype):
    baked = port_bake(table_dtype=table_dtype)
    path = tmp_path / "snap" / "baked.pt"
    tb.save_baked(str(path), baked)
    assert [p.name for p in path.parent.iterdir()] == ["baked.pt"]  # no .tmp
    again = tb.load_baked(str(path))
    assert again["config"] == baked["config"]
    assert set(again) == set(baked)
    for key in tb._ARRAYS:
        if key in baked:
            assert again[key].dtype == baked[key].dtype
            assert torch.equal(again[key], baked[key]), key
    for a, b in zip(again["color_net"], baked["color_net"]):
        assert torch.equal(a["w"], b["w"])


@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
def test_load_baked_reads_a_jax_snapshot(tmp_path, table_dtype):
    jbaked = jax_bake(table_dtype=table_dtype)
    path = str(tmp_path / "snap.msgpack")
    jb.save_baked(path, jbaked)
    got, want = tb.load_baked(path), crossed(jbaked)
    assert got["config"] == want["config"]
    for key in tb._ARRAYS:
        assert (key in got) == (key in want)
        if key in want:
            assert got[key].dtype == want[key].dtype
            assert torch.equal(got[key], want[key]), key
    for a, b in zip(got["color_net"], want["color_net"]):
        assert torch.equal(a["w"], b["w"])


def test_load_baked_refuses_another_file(tmp_path):
    path = str(tmp_path / "x.pt")
    torch.save({"format": "something else"}, path)
    with pytest.raises(ValueError, match="not a baked snapshot"):
        tb.load_baked(path)


@pytest.mark.parametrize("kw,match", [
    (dict(sigma_enc="linear"), "sigma_enc must be"),
    (dict(resolution=10), "divisible by 4"),
    (dict(resolution=8, geo_resolution=3), "geo_resolution must divide"),
    (dict(table_dtype="float16"), "table_dtype"),
    (dict(geo_feat_dim=16), "geo_feat_dim <= 15"),
])
def test_bake_field_value_errors(kw, match):
    _, _, tfc, tparams = fields()
    if "geo_feat_dim" in kw:
        tfc = dataclasses.replace(tfc, geo_feat_dim=kw.pop("geo_feat_dim"))
    with pytest.raises(ValueError, match=match):
        tb.bake_field(tparams, tfc, **{"resolution": 8, **kw})


def test_tile_size_follows_the_bytes_a_tile_holds():
    baked = port_bake()
    assert tb.default_baked_tile_rays(baked, 128, 4) == tb.CPU_TILE_RAYS
    few, many = (tb.baked_bytes_per_ray(baked, s, 4) for s in (16, 128))
    assert few < many
    assert tb.baked_bytes_per_ray(baked, 16, None) > few  # every sample fetched
