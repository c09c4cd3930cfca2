"""The hash grid of the parity path (``--i_embed 1``), PE and the hash-grid
TV loss in the port, against the JAX package on the same numpy inputs.

Tolerances: the corner rows (``flat_idx``) and the keep mask bit for bit;
the trilinear weights bit for bit (the JAX op order, f32); the encode 1e-6
of its largest entry (a sum of 8 products in another order); the table
gradient 1e-6 of its largest entry (the same products, summed per table
row in another order); PE 1e-6 (sin and cos of exact arguments, each
library within an ulp or two); the TV value 1e-5 relative (f32 sums of up
to 16 x 3 x 51^3 squares in other orders), its gradient 1e-6 of the
largest entry (each entry a sum of at most 6 terms). The card against the
CPU: tests/test_torch_parity_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indoor_nerf_tpu.ops import encoding as je
from indoor_nerf_tpu.ops import hashing as jh
from indoor_nerf_tpu.ops import tv as jtv
from indoor_nerf_tpu_torch.ops import encoding as te
from indoor_nerf_tpu_torch.ops import hashing as th
from indoor_nerf_tpu_torch.ops import tv as ttv

torch.set_num_threads(1)

GRID_FIELDS = ("bbox_min", "bbox_max", "n_levels", "n_features_per_level",
               "log2_hashmap_size", "base_resolution", "finest_resolution")


def _grids(**kw):
    """(JAX, port) HashGridConfig of one geometry: an uneven box."""
    kw = {"bbox_min": (-1.3, -0.7, -2.1), "bbox_max": (1.1, 0.9, 1.7),
          "n_levels": 8, "log2_hashmap_size": 12, "finest_resolution": 128,
          **kw}
    return je.HashGridConfig(**kw), te.HashGridConfig(**kw)


def test_copies_equal_the_jax_ones():
    """The port's copies of BOX_OFFSETS, the primes, HashGridConfig,
    level_resolutions and _level_cube_size."""
    np.testing.assert_array_equal(th.BOX_OFFSETS, jh.BOX_OFFSETS)
    assert th.BOX_OFFSETS.dtype == jh.BOX_OFFSETS.dtype
    assert [int(p) for p in jh._PRIMES] == list(th.PRIMES)
    jg, tg = je.HashGridConfig((0, 0, 0), (1, 1, 1)), \
        te.HashGridConfig((0, 0, 0), (1, 1, 1))
    for f in GRID_FIELDS + ("table_size", "out_dim"):
        assert getattr(tg, f) == getattr(jg, f), f
    for L, base, finest in ((16, 16, 512), (8, 16, 128), (1, 16, 16),
                            (12, 8, 2048)):
        jg, tg = _grids(n_levels=L, base_resolution=base,
                        finest_resolution=finest)
        np.testing.assert_array_equal(te.level_resolutions(tg),
                                      je.level_resolutions(jg))
        for r in je.level_resolutions(jg):
            assert ttv._level_cube_size(r, base) == \
                jtv._level_cube_size(r, base)


@pytest.mark.parametrize("log2", [4, 12, 19, 24, 31])
def test_spatial_hash_is_bit_exact(rng, log2):
    """Coordinates over the whole int32 range, negative ones included:
    products far past 2^31 (the JAX hash wraps in uint32, the port's in
    int64; the masked low bits agree)."""
    c = rng.integers(-2**31, 2**31 - 1, size=(4000, 3)).astype(np.int32)
    c[:8] = [[2**31 - 1] * 3, [-2**31] * 3, [0, 0, 0], [1, 1, 1],
             [-1, -1, -1], [511, 512, 513], [2**16, 2**20, 2**30], [7, 0, 0]]
    want = np.asarray(jh.spatial_hash(jnp.asarray(c), log2)).astype(np.int64)
    got = th.spatial_hash(torch.from_numpy(c), log2)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # Up to 7 dimensions, as the JAX hash.
    c7 = rng.integers(0, 2**20, size=(500, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        th.spatial_hash(torch.from_numpy(c7), log2).numpy(),
        np.asarray(jh.spatial_hash(jnp.asarray(c7), log2)).astype(np.int64))


def _points(rng, jg, n=3000):
    """Random points (some outside the box), points on voxel faces of every
    level (a face coordinate formed as JAX forms the grid: min + i * size),
    and the box's corners and faces."""
    bmin = np.asarray(jg.bbox_min, np.float32)
    bmax = np.asarray(jg.bbox_max, np.float32)
    res = je.level_resolutions(jg)
    size = (bmax - bmin)[None, :] / res[:, None]  # [L, 3] f32
    pts = [rng.uniform(bmin - 0.3, bmax + 0.3, (n, 3)).astype(np.float32)]
    lv = rng.integers(0, jg.n_levels, n)
    i = np.floor(rng.uniform(0, 1, (n, 3)) * res[lv][:, None]).astype(np.float32)
    face = (bmin + i * size[lv]).astype(np.float32)
    # Faces on one axis only, the other two random inside the box.
    mixed = rng.uniform(bmin, bmax, (n, 3)).astype(np.float32)
    ax = rng.integers(0, 3, n)
    mixed[np.arange(n), ax] = face[np.arange(n), ax]
    corners = np.array([[a, b, c] for a in (bmin[0], bmax[0])
                        for b in (bmin[1], bmax[1])
                        for c in (bmin[2], bmax[2])], np.float32)
    box_faces = rng.uniform(bmin, bmax, (60, 3)).astype(np.float32)
    axis = np.arange(60) % 3
    box_faces[np.arange(60), axis] = np.where(
        np.arange(60) % 2 == 0, bmin[axis], bmax[axis])
    return np.concatenate(pts + [face, mixed, corners, box_faces])


@pytest.mark.parametrize("geometry", [
    {},  # an uneven box, 8 levels to 128
    {"n_levels": 16, "log2_hashmap_size": 19, "finest_resolution": 512,
     "bbox_min": (-1.5, -1.5, -1.5), "bbox_max": (1.5, 1.5, 1.5)},
])
def test_hash_grid_indices_match_jax(rng, geometry):
    jg, tg = _grids(**geometry)
    x = _points(rng, jg)
    jf, jw, jk = (np.asarray(v) for v in je.hash_grid_indices(jnp.asarray(x), jg))
    tf, tw, tk = te.hash_grid_indices(torch.from_numpy(x), tg)
    assert tf.dtype == torch.int32 and tf.shape == (len(x), jg.n_levels, 8)
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_array_equal(tw.numpy(), jw)
    assert (~jk).any() and jk.any()
    # The face points sit on a face of their level: a weight of exactly 0.
    assert np.any(tw.numpy() == 0.0)


def test_trilinear_interp_matches_jax(rng):
    feats = rng.standard_normal((500, 4, 8, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (500, 4, 3)).astype(np.float32)
    w[:50] = 0.0
    want = np.asarray(je.trilinear_interp(jnp.asarray(feats), jnp.asarray(w)))
    got = te.trilinear_interp(torch.from_numpy(feats), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n_features", [2, 4])
def test_hash_encode_and_table_gradient_match_jax(rng, n_features):
    jg, tg = _grids(n_features_per_level=n_features)
    x = _points(rng, jg, 2000)
    table = rng.standard_normal(
        (jg.n_levels * jg.table_size, n_features)).astype(np.float32)
    want, wk = je.hash_encode(jnp.asarray(x), jnp.asarray(table), jg)
    tt = torch.from_numpy(table).requires_grad_(True)
    got, gk = te.hash_encode(torch.from_numpy(x), tt, tg)
    want = np.asarray(want)
    assert got.shape == want.shape == (len(x), jg.out_dim)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    cot = rng.standard_normal(want.shape).astype(np.float32)
    jgrad = np.asarray(jax.grad(lambda t: jnp.sum(
        je.hash_encode(jnp.asarray(x), t, jg)[0] * cot))(jnp.asarray(table)))
    (tgrad,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), tt)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, rtol=0,
                               atol=1e-6 * np.abs(jgrad).max())
    assert np.count_nonzero(jgrad) > 0


def test_init_hash_table_shape_and_range():
    _, tg = _grids()
    t = te.init_hash_table(torch.Generator().manual_seed(0), tg)
    assert t.shape == (tg.n_levels * tg.table_size, 2) and t.dtype == torch.float32
    assert 0 < float(t.abs().max()) <= 1e-4


@pytest.mark.parametrize("multires", [10, 4])
def test_positional_encode_matches_jax(rng, multires):
    x = rng.uniform(-1.5, 1.5, (2000, 3)).astype(np.float32)
    want = np.asarray(je.positional_encode(jnp.asarray(x), multires))
    got = te.positional_encode(torch.from_numpy(x), multires)
    assert got.shape[-1] == te.positional_encode_dim(multires) == \
        je.positional_encode_dim(multires)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    freqs = 2.0 ** torch.linspace(0.0, multires - 1, multires)
    assert freqs.tolist() == [2.0 ** i for i in range(multires)]


@pytest.mark.parametrize("geometry", [
    {},
    {"n_levels": 16, "log2_hashmap_size": 14, "finest_resolution": 512},
])
def test_total_variation_loss_matches_jax(rng, geometry):
    """Value and table gradient with the JAX cube origins replayed."""
    from _torch_parity import jax_tv_origins

    jg, tg = _grids(**geometry)
    table = rng.standard_normal(
        (jg.n_levels * jg.table_size, 2)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jval, jgrad = jax.value_and_grad(
        lambda t: jtv.total_variation_loss(key, t, jg))(jnp.asarray(table))
    origins = torch.from_numpy(jax_tv_origins(key, jg))
    tt = torch.from_numpy(table).requires_grad_(True)
    got = ttv.total_variation_loss(tt, tg, origins)
    np.testing.assert_allclose(float(got.detach()), float(jval), rtol=1e-5)
    (tgrad,) = torch.autograd.grad(got, tt)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, rtol=0,
                               atol=1e-6 * np.abs(jgrad).max())


def test_draw_tv_origins_range():
    """Each level's origin lies in [0, resolution - cube) per axis."""
    _, tg = _grids(n_levels=16, finest_resolution=512)
    o = ttv.draw_tv_origins(torch.Generator().manual_seed(0), tg)
    assert o.shape == (16, 3) and o.dtype == torch.int64
    for level, (res, cube) in enumerate(ttv._cubes(tg)):
        assert 0 <= int(o[level].min()) and int(o[level].max()) < res - cube
