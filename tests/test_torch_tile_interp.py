"""The tile-interp route of the encode: ``ops/tile_interp.py`` and the
``--use_pallas`` path against the JAX package, and the CUDA kernels against
their plain versions.

The JAX ``tile_interp`` takes no ``interpret`` argument: off the TPU it runs
its jnp reference (``_reference_interp`` and the jnp ``d rows``), which is
how the JAX package's own tests run it, and what the port is held against
here. The JAX switch is the module global ``USE_TILE_INTERP_KERNEL``, read
at trace time, so the ``tile_route`` fixture sets it and clears JAX's trace
caches before and after.

Everything of jax is imported inside fixtures, so that the CUDA tests of
this file also run on a card's machine, which has no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_tile_interp.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from indoor_nerf_tpu_torch.ops import blockhash as tbh
from indoor_nerf_tpu_torch.ops import tile_interp as ti

torch.set_num_threads(1)

T = torch.from_numpy

# The block-hash defaults at test size: 4 levels x 2 features, block_size 4,
# f32 IO, finest_res 32, log2_hashmap_size 14.
TINY_TILE = [
    "--i_embed", "3", "--use_pallas", "--use_occupancy", "--N_importance", "0",
    "--occ_weighting", "transmittance", "--dataset_type", "synthetic",
    "--use_viewdirs", "--white_bkgd", "--n_levels", "4", "--finest_res", "32",
    "--log2_hashmap_size", "14", "--occ_resolution", "16",
    "--occ_candidates", "32", "--occ_samples", "8",
]
GRID = dict(bbox_min=(-1.0, -1.2, -0.8), bbox_max=(1.1, 1.0, 1.3), n_levels=4,
            n_features_per_level=2, log2_rows=7, base_resolution=4,
            finest_resolution=32, block_size=4)


@pytest.fixture
def jx():
    """jax, jax.numpy and the JAX package's modules of this route."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import indoor_nerf_tpu.ops.blockhash as jbh
    from indoor_nerf_tpu.ops.pallas import tile_interp as jti

    return jax, jnp, jbh, jti


@pytest.fixture
def tile_route(jx, monkeypatch):
    """The JAX encode on its tile_interp route, traced fresh."""
    jax, _, jbh, _ = jx
    jax.clear_caches()
    monkeypatch.setattr(jbh, "USE_TILE_INTERP_KERNEL", True)
    yield
    jax.clear_caches()


def _rows_p_g(seed, M, kinks=True):
    """Random rows, cotangents and in-tile positions; with ``kinks`` some
    positions are integers and some sit on the far face ``p = 4``."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((M, 2 * ti.LANES)).astype(np.float32)
    g = rng.standard_normal((M, 2)).astype(np.float32)
    if kinks:
        p = rng.uniform(0.0, ti.SIDE - 1, size=(M, 3)).astype(np.float32)
        k = min(16, M // 4)
        p[:k] = rng.integers(0, ti.SIDE, size=(k, 3)).astype(np.float32)
        p[k:k + 4] = ti.SIDE - 1
    else:  # off the tent kinks, where the sub-gradient is ambiguous
        p = rng.uniform(0.1, 3.9, size=(M, 3)).astype(np.float32)
        p = np.where(np.abs(p - np.round(p)) < 0.05, p + 0.07, p)
    return rows, p.astype(np.float32), g


@pytest.mark.parametrize("M", [1, 37, 1024, 2500])
def test_forward_and_d_rows_match_jax(jx, M):
    """Forward and ``d rows`` against the JAX ``tile_interp`` and ``jax.grad``
    of it, kinks included: the same products, sums in another order, so
    rtol 1e-5 / atol 1e-6 (the JAX test's own)."""
    jax, jnp, _, jti = jx
    rows, p, g = _rows_p_g(M, M)
    want = jti.tile_interp(jnp.asarray(rows), jnp.asarray(p))
    want_dr = jax.grad(lambda r: jnp.sum(jti.tile_interp(r, jnp.asarray(p)) * g))(
        jnp.asarray(rows))
    tr = T(rows).requires_grad_(True)
    got = ti.tile_interp(tr, T(p))
    (got_dr,) = torch.autograd.grad(got, tr, grad_outputs=T(g))
    assert got.shape == (M, 2) and got_dr.shape == (M, 256)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_dr.numpy(), np.asarray(want_dr),
                               rtol=1e-5, atol=1e-6)
    # The dead lanes 125..127 of both planes carry no gradient.
    assert not got_dr[:, 125:128].any() and not got_dr[:, 253:256].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_d_p_matches_jax_off_the_kinks(jx, seed):
    """``d p`` (and ``d rows`` beside it) against ``jax.grad`` of the custom
    VJP and of the jnp reference under plain autodiff: rtol 1e-4 / atol
    1e-5, the JAX test's own tolerance."""
    jax, jnp, _, jti = jx
    rows, p, g = _rows_p_g(10 + seed, 300, kinks=False)
    want_dr, want_dp = jax.grad(
        lambda r, q: jnp.sum(jti.tile_interp(r, q) * g), argnums=(0, 1))(
        jnp.asarray(rows), jnp.asarray(p))
    ref_dp = jax.grad(lambda q: jnp.sum(
        jti._reference_interp(jnp.asarray(rows), q) * g))(jnp.asarray(p))
    tr, tp = T(rows).requires_grad_(True), T(p).requires_grad_(True)
    got_dr, got_dp = torch.autograd.grad(ti.tile_interp(tr, tp), (tr, tp),
                                         grad_outputs=T(g))
    np.testing.assert_allclose(got_dr.numpy(), np.asarray(want_dr), rtol=1e-5,
                               atol=1e-6)
    for want in (want_dp, ref_dp):
        np.testing.assert_allclose(got_dp.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_d_p_at_the_kinks_is_the_jax_value(jx):
    """At an integer position the derivative along that axis is 0 on both
    sides (sign(0) = 0 under the point, |l - p| = 1 outside the open
    support beside it)."""
    jax, jnp, _, jti = jx
    rows, p, g = _rows_p_g(3, 64)
    p[:, 0] = np.round(p[:, 0])  # every x on a kink
    want = jax.grad(lambda q: jnp.sum(
        jti.tile_interp(jnp.asarray(rows), q) * g))(jnp.asarray(p))
    tp = T(p).requires_grad_(True)
    (got,) = torch.autograd.grad(ti.tile_interp(T(rows), tp), tp,
                                 grad_outputs=T(g))
    assert not got[:, 0].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_rows_are_kept_only_when_p_needs_a_gradient():
    rows, p, _ = _rows_p_g(4, 8)
    tr = T(rows).requires_grad_(True)
    out = ti.tile_interp(tr, T(p))
    assert [None if t is None else tuple(t.shape)
            for t in out.grad_fn.saved_tensors] == [(8, 3), None]
    out = ti.tile_interp(tr, T(p).requires_grad_(True))
    assert [tuple(t.shape) for t in out.grad_fn.saved_tensors] == \
        [(8, 3), (8, 256)]


def test_cpu_tensors_take_the_plain_versions():
    rows, p, g = _rows_p_g(5, 50)
    ti.reset_launch_count()
    out = ti.tile_interp_fwd(T(rows), T(p))
    drows = ti.tile_interp_bwd_rows(T(p), T(g))
    assert [ti.launch_count(k) for k in ti.KERNELS] == [0, 0]  # no kernel ran
    assert torch.equal(out, ti.tile_interp_fwd_plain(T(rows), T(p)))
    assert torch.equal(drows, ti.tile_interp_bwd_rows_plain(T(p), T(g)))


def test_wrappers_reject_what_the_kernels_do_not_take():
    rows, p, g = (T(a) for a in _rows_p_g(6, 10))
    with pytest.raises(TypeError):
        ti.tile_interp_fwd(rows.double(), p)
    with pytest.raises(TypeError):
        ti.tile_interp_fwd(rows[:, :128], p)  # one feature plane
    with pytest.raises(TypeError):
        ti.tile_interp_fwd(rows, p[:, :2])
    with pytest.raises(ValueError):
        ti.tile_interp_fwd(rows, p[:5])
    with pytest.raises(TypeError):
        ti.tile_interp_bwd_rows(p, g.to(torch.bfloat16))
    with pytest.raises(ValueError):
        ti.tile_interp_fwd(rows.to("meta"), p.to("meta"))
    with pytest.raises(ValueError):
        ti.tile_interp_bwd_rows(p.to("meta"), g.to("meta"))


def _encode_inputs(seed, n=300, inside=False, width=256):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(GRID["bbox_min"]), np.asarray(GRID["bbox_max"])
    if inside:  # strictly inside: clip and min/max differ only on a face
        x = rng.uniform(lo + 0.01, hi - 0.01, size=(n, 3)).astype(np.float32)
    else:
        x = rng.uniform(lo - 0.3, hi + 0.3, size=(n, 3)).astype(np.float32)
    table = rng.standard_normal((GRID["n_levels"] << GRID["log2_rows"], width)
                                ).astype(np.float32)
    c = rng.standard_normal((n, 2 * GRID["n_levels"])).astype(np.float32)
    return x, table, c


@pytest.mark.parametrize("gather_dtype", ["float32", "bfloat16"])
def test_encode_features_match_jax(jx, tile_route, gather_dtype):
    """Features and keep mask of the tile route against the JAX encode with
    ``USE_TILE_INTERP_KERNEL`` on, points outside the bbox included: the
    rows selected are the same, the sums differ in order only."""
    _, jnp, jbh, _ = jx
    kw = dict(GRID, gather_dtype=gather_dtype, scatter_dtype="float32")
    x, table, _ = _encode_inputs(20)
    want, want_keep = jbh.block_hash_encode(jnp.asarray(x), jnp.asarray(table),
                                            jbh.BlockHashConfig(**kw))
    tcfg = tbh.BlockHashConfig(**kw, tile_interp=True)
    assert tcfg.uses_tile_interp
    got, keep = tbh.block_hash_encode(T(x), T(table), tcfg)
    assert got.shape == (300, 8) and got.dtype == torch.float32
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("levels", [None, (1, 3)])
def test_encode_gradients_match_jax(jx, tile_route, levels):
    """d table and dx of <feats, c> for a fixed cotangent c. The table's
    gradient sums the same f32 ``d rows`` entries in another order (1e-5,
    absolute against entries of O(1)); ``dx`` goes through the tent
    derivative and the level scales (rtol 1e-4, atol 1e-4 against entries of
    O(10)), at points strictly inside the bbox, where ``jnp.clip`` and
    ``minimum(maximum())`` have one gradient."""
    jax, jnp, jbh, _ = jx
    kw = dict(GRID, gather_dtype="float32", scatter_dtype="float32")
    x, table, c = _encode_inputs(21, inside=True)
    n_lv = GRID["n_levels"] if levels is None else len(levels)
    c = c[:, :2 * n_lv]
    jcfg = jbh.BlockHashConfig(**kw)
    want_t, want_x = jax.grad(lambda t, q: jnp.sum(
        jbh.block_hash_encode(q, t, jcfg, levels)[0] * c), argnums=(0, 1))(
        jnp.asarray(table), jnp.asarray(x))
    tt, tx = T(table).requires_grad_(True), T(x).requires_grad_(True)
    feats, _ = tbh.block_hash_encode(
        tx, tt, tbh.BlockHashConfig(**kw, tile_interp=True), levels)
    got_t, got_x = torch.autograd.grad(feats, (tt, tx), grad_outputs=T(c))
    assert got_t.dtype == torch.float32 and got_t.shape == tt.shape
    assert float(np.abs(np.asarray(want_t)).max()) > 0.1
    assert float(np.abs(np.asarray(want_x)).max()) > 1.0
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-4,
                               atol=1e-4)


def test_tile_route_agrees_with_the_default_route():
    """The port's two routes compute one function: the same features, and
    the same table gradient up to the order of the f32 sums."""
    kw = dict(GRID, gather_dtype="float32", scatter_dtype="float32")
    x, table, c = _encode_inputs(22)
    grads, feats = [], []
    for tile in (False, True):
        tt = T(table).requires_grad_(True)
        f, _ = tbh.block_hash_encode(T(x), tt, tbh.BlockHashConfig(
            **kw, tile_interp=tile))
        (g,) = torch.autograd.grad(f, tt, grad_outputs=T(c))
        feats.append(f.detach().numpy())
        grads.append(g.numpy())
    np.testing.assert_allclose(feats[1], feats[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-5, atol=1e-5)


def test_default_route_still_refuses_a_point_gradient():
    kw = dict(GRID, gather_dtype="float32", scatter_dtype="float32")
    x, table, _ = _encode_inputs(23)
    with pytest.raises(NotImplementedError, match="gradient w.r.t. the encoded"):
        tbh.block_hash_encode(T(x).requires_grad_(True), T(table),
                              tbh.BlockHashConfig(**kw))


def test_other_feature_counts_raise():
    """JAX fails at a reshape with F != 2 on this route; the port says so."""
    kw = dict(GRID, gather_dtype="float32", scatter_dtype="float32",
              n_features_per_level=4)
    with pytest.raises(ValueError, match="two 128-lane feature planes"):
        tbh.BlockHashConfig(**kw, tile_interp=True)
    tbh.BlockHashConfig(**kw)  # fine on the default route


@pytest.mark.parametrize("override", [
    dict(block_size=3), dict(scatter_dtype="bfloat16", gather_dtype="bfloat16")])
def test_flag_is_ignored_where_jax_ignores_it(jx, tile_route, override):
    """At ``block_size 3`` the JAX package never reaches ``tile_interp``, and
    at a bf16 scatter its encode is the fused VJP whatever the switch says
    (on the TPU its forward is the ``tent_contract`` kernel); the port's
    config then takes the default route, with the default route's numbers
    bit for bit."""
    _, jnp, jbh, _ = jx
    kw = {**GRID, "gather_dtype": "float32", "scatter_dtype": "float32",
          **override}
    # A side-4 tile of 2 features fills 2 x 64 lanes.
    x, table, _ = _encode_inputs(
        24, width=128 if override.get("block_size") == 3 else 256)
    asked = tbh.BlockHashConfig(**kw, tile_interp=True)
    assert not asked.uses_tile_interp
    got, _ = tbh.block_hash_encode(T(x), T(table), asked)
    plain, _ = tbh.block_hash_encode(T(x), T(table), tbh.BlockHashConfig(**kw))
    assert torch.equal(got, plain)
    want, _ = jbh.block_hash_encode(jnp.asarray(x), jnp.asarray(table),
                                    jbh.BlockHashConfig(**kw))
    tol = 2e-2 if "bfloat16" in override.values() else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_trainer_config_takes_and_ignores_the_flag(capsys):
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    args = parse_args(TINY_TILE)
    bg = build_train_config(args, load_dataset(args)).render.field.block_grid
    assert bg.uses_tile_interp and (bg.block_size, bg.n_features_per_level,
                                    bg.scatter_dtype) == (4, 2, "float32")
    assert "[pallas] tile_interp kernel enabled" in capsys.readouterr().out
    args = parse_args(TINY_TILE + ["--block_size", "3"])
    bg = build_train_config(args, load_dataset(args)).render.field.block_grid
    assert bg.tile_interp and not bg.uses_tile_interp
    assert "--use_pallas ignored" in capsys.readouterr().out
    args = parse_args(TINY_TILE + ["--feats_per_level", "4"])
    with pytest.raises(ValueError, match="two 128-lane feature planes"):
        build_train_config(args, load_dataset(args))
    # The full-size defaults: a [65536, 256] f32 table, 16 levels x 2.
    cut = TINY_TILE.index("--n_levels")  # drop the three size flags
    args = parse_args(TINY_TILE[:cut] + TINY_TILE[cut + 6:])
    bg = build_train_config(args, load_dataset(args)).render.field.block_grid
    assert (bg.n_levels, bg.log2_rows, bg.finest_resolution) == (16, 12, 512)
    assert (bg.n_levels * bg.rows_per_level,
            bg.n_features_per_level * bg.lanes_per_feature) == (65536, 256)


def test_train_step_matches_jax_on_the_tile_route(jx, tile_route):
    """One full step at the block-hash defaults (tiny size) on the tile
    route of both packages, the JAX draws replayed; tolerances as
    ``tests/test_torch_train_step.py::test_train_step_matches_jax``."""
    from _torch_parity import check_train_step_matches_jax, configs

    _, tcfg, _ = configs(TINY_TILE)
    assert tcfg.render.field.block_grid.uses_tile_interp
    check_train_step_matches_jax(TINY_TILE)


def test_trainer_runs_the_use_pallas_cli_on_cpu(capsys):
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import train

    out = train(parse_args(TINY_TILE + [
        "--device", "cpu", "--N_rand", "64", "--n_iters", "3", "--i_print", "1",
        "--lrate", "0.01"]))
    assert out["state"]["step"] == 3 and np.all(np.isfinite(out["losses"]))
    assert "[pallas] tile_interp kernel enabled" in capsys.readouterr().out


def test_render_on_the_tile_route_matches_the_default_route():
    """A test-mode image through both routes of one config, and the tile
    size the tile route's bytes per ray give."""
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.models.field import init_field_params
    from indoor_nerf_tpu_torch.ops.occupancy import init_occupancy
    from indoor_nerf_tpu_torch.render import renderer
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    args = parse_args(TINY_TILE)
    scene = load_dataset(args)
    tile_cfg = build_train_config(args, scene).render
    fc = tile_cfg.field
    plain_cfg = dataclasses.replace(tile_cfg, field=dataclasses.replace(
        fc, block_grid=dataclasses.replace(fc.block_grid, tile_interp=False)))
    params = init_field_params(torch.Generator().manual_seed(0), fc)
    params["table"] = torch.randn(params["table"].shape,
                                  generator=torch.Generator().manual_seed(1))
    occ = init_occupancy(tile_cfg.occupancy)
    imgs = [renderer.render_image(params, 8, 8, scene.K, scene.poses[0],
                                  scene.near, scene.far, cfg, occ_state=occ)
            for cfg in (tile_cfg, plain_cfg)]
    np.testing.assert_allclose(imgs[0]["rgb_map"], imgs[1]["rgb_map"],
                               rtol=0, atol=1e-5)
    # 8 samples x 4 levels x 1 KiB of gathered rows on top of the flagship's.
    assert renderer.bytes_per_ray(plain_cfg) == renderer.BYTES_PER_RAY
    assert renderer.bytes_per_ray(tile_cfg) == \
        renderer.BYTES_PER_RAY + 8 * 4 * 1024
    assert renderer.default_tile_rays(torch.device("cpu"), tile_cfg) == \
        renderer.CPU_TILE_RAYS


@pytest.mark.cuda
@pytest.mark.parametrize("M", [262144, 100003, 5])
def test_cuda_kernels_match_plain(M):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rows, p, g = (T(a).cuda() for a in _rows_p_g(7, M))
    ti.reset_launch_count()
    out = ti.tile_interp_fwd(rows, p)
    drows = ti.tile_interp_bwd_rows(p, g)
    torch.cuda.synchronize()
    assert [ti.launch_count(k) for k in ti.KERNELS] == [1, 1]
    # Forward: f32 sums in another order. d rows: the same products, no
    # contraction, so bit for bit.
    torch.testing.assert_close(out, ti.tile_interp_fwd_plain(rows, p),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(drows, ti.tile_interp_bwd_rows_plain(p, g))


@pytest.mark.cuda
def test_cuda_autograd_function_runs_both_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rows, p, g = (T(a).cuda() for a in _rows_p_g(8, 4096, kinks=False))
    rows.requires_grad_(True)
    p.requires_grad_(True)
    ti.reset_launch_count()
    out = ti.tile_interp(rows, p)
    d_rows, d_p = torch.autograd.grad(out, (rows, p), grad_outputs=g)
    assert [ti.launch_count(k) for k in ti.KERNELS] == [1, 1]
    cr = rows.detach().cpu().requires_grad_(True)
    cp = p.detach().cpu().requires_grad_(True)
    w_rows, w_p = torch.autograd.grad(ti.tile_interp(cr, cp), (cr, cp),
                                      grad_outputs=g.cpu())
    torch.testing.assert_close(d_rows.cpu(), w_rows, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(d_p.cpu(), w_p, rtol=1e-4, atol=1e-5)
