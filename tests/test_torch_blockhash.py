"""Port parity: the block-hash encode forward against the JAX package.

Same numpy-seeded points and tables through both. Row selection must be
EXACT: block faces are C0 seams, so a one-ulp difference in the in-tile
coordinate can change which row a point reads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indoor_nerf_tpu.ops.blockhash as jbh
from indoor_nerf_tpu.ops.encoding import level_resolutions as j_level_resolutions
from indoor_nerf_tpu_torch.ops import blockhash as tbh
from indoor_nerf_tpu_torch.ops.encoding import level_resolutions
from indoor_nerf_tpu_torch.ops.tent_contract import unpack_rows

torch.set_num_threads(1)

_GEOM = dict(bbox_min=(-1.0, -1.2, -0.8), bbox_max=(1.1, 1.0, 1.3),
             n_levels=4, n_features_per_level=4, log2_rows=6,
             base_resolution=4, finest_resolution=32)


def _configs(block_size=3, gather="bfloat16"):
    scatter = "bfloat16" if gather == "bfloat16" else "float32"
    kw = dict(_GEOM, block_size=block_size, gather_dtype=gather,
              scatter_dtype=scatter)
    return jbh.BlockHashConfig(**kw), tbh.BlockHashConfig(**kw)


def _points(rng, n=512):
    # Some points fall outside the bbox to exercise the clamp + keep mask.
    return rng.uniform(-1.3, 1.4, size=(n, 3)).astype(np.float32)


def _table(rng, cfg):
    shape = (cfg.n_levels * cfg.rows_per_level,
             cfg.n_features_per_level * cfg.lanes_per_feature)
    return rng.standard_normal(shape).astype(np.float32)


def test_level_resolutions_copy_is_identical():
    jcfg, tcfg = _configs()
    np.testing.assert_array_equal(
        level_resolutions(tcfg), j_level_resolutions(jcfg.as_hash_grid()))
    for L, base, finest in [(8, 16, 512), (16, 16, 2048), (1, 16, 512)]:
        jc = jbh.BlockHashConfig((0,) * 3, (1,) * 3, n_levels=L,
                                 base_resolution=base, finest_resolution=finest)
        np.testing.assert_array_equal(
            level_resolutions(jc), j_level_resolutions(jc.as_hash_grid()))


def test_stagger_is_identical():
    for L, B in [(8, 3), (16, 4)]:
        np.testing.assert_array_equal(tbh._stagger(L, B), jbh._stagger(L, B))


def test_block_row_hash_exact(rng):
    block = rng.integers(0, 1 << 12, size=(300, 8, 3)).astype(np.int32)
    level = np.arange(8, dtype=np.int32)[None, :]
    for log2_rows in (6, 13):
        want = np.asarray(jbh._block_row_hash(
            jnp.asarray(block), jnp.asarray(level), log2_rows))
        got = tbh._block_row_hash(torch.from_numpy(block),
                                  torch.from_numpy(level), log2_rows)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("block_size", [3, 4])
def test_tile_coords_exact(rng, block_size):
    jcfg, tcfg = _configs(block_size)
    x = _points(rng)
    j_row, j_p, j_keep = jbh._tile_coords(jnp.asarray(x), jcfg)
    t_row, t_p, t_keep = tbh._tile_coords(torch.from_numpy(x), tcfg)
    assert t_row.dtype == torch.int32
    np.testing.assert_array_equal(t_row.numpy(), np.asarray(j_row))
    np.testing.assert_array_equal(t_keep.numpy(), np.asarray(j_keep))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(j_p), rtol=0, atol=1e-6)


@pytest.mark.parametrize("gather", ["bfloat16", "float32"])
def test_encode_matches_jax_plain_path(rng, gather):
    """The JAX CPU path is the jnp gather + tent form; summation order
    differs (XLA reduce vs torch.sum), so 1e-6."""
    jcfg, tcfg = _configs(gather=gather)
    x = _points(rng)
    table = _table(rng, tcfg)
    want, want_keep = jbh.block_hash_encode(jnp.asarray(x), jnp.asarray(table),
                                            jcfg)
    got, keep = tbh.block_hash_encode(torch.from_numpy(x),
                                      torch.from_numpy(table), tcfg)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # The cached packed gather copy gives the same features as the master.
    cached, _ = tbh.block_hash_encode(
        torch.from_numpy(x), tbh.gather_table(torch.from_numpy(table), tcfg),
        tcfg)
    np.testing.assert_array_equal(cached.numpy(), got.numpy())


@pytest.mark.parametrize("block_size,gather", [(3, "bfloat16"), (3, "float32"),
                                               (4, "float32")])
def test_gather_table_is_the_packed_copy(rng, block_size, gather):
    """``[L*R, lpf, F]`` in the gather dtype, element [r, lane, f] the
    master's [r, f*lpf + lane]; the 3-D shape marks it (an f32 copy too),
    and a packed copy goes through unchanged."""
    _, tcfg = _configs(block_size, gather)
    master = torch.from_numpy(_table(rng, tcfg))
    want = torch.bfloat16 if gather == "bfloat16" else torch.float32
    packed = tbh.gather_table(master, tcfg)
    F, lpf = tcfg.n_features_per_level, tcfg.lanes_per_feature
    assert packed.shape == (master.shape[0], lpf, F) and packed.dtype == want
    np.testing.assert_array_equal(
        packed.float().numpy(),
        master.to(want).float().view(-1, F, lpf).transpose(1, 2).numpy())
    assert tbh.gather_table(packed, tcfg) is packed
    with pytest.raises(TypeError):
        tbh.gather_table(master.to(torch.float16), tcfg)
    other = torch.float32 if want == torch.bfloat16 else torch.bfloat16
    with pytest.raises(TypeError):
        tbh.gather_table(packed.to(other), tcfg)


@pytest.mark.parametrize("levels", [None, (1, 2)])
def test_serving_params_encode_matches_jax(rng, levels):
    """A server's packed table (``serving_params``) through the encode, all
    levels and a subset, against the JAX encode of the master: the
    tolerance of ``test_encode_matches_jax_plain_path``."""
    from indoor_nerf_tpu_torch.models.field import FieldConfig, serving_params

    jcfg, tcfg = _configs()
    x = _points(rng)
    table = _table(rng, tcfg)
    want, want_keep = jbh.block_hash_encode(jnp.asarray(x), jnp.asarray(table),
                                            jcfg, levels=levels)
    params = serving_params({"table": torch.from_numpy(table)},
                            FieldConfig(block_grid=tcfg))
    assert params["table"].dim() == 3 and params["table"].dtype == torch.bfloat16
    got, keep = tbh.block_hash_encode(torch.from_numpy(x), params["table"],
                                      tcfg, levels=levels)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_tile_interp_route_keeps_the_master_layout(rng):
    """The tile-interp route gathers whole feature-plane rows: a server
    leaves its table unpacked there, and a packed one is refused."""
    from indoor_nerf_tpu_torch.models.field import FieldConfig, serving_params

    kw = dict(_GEOM, n_features_per_level=2, block_size=4, tile_interp=True)
    jcfg, tcfg = jbh.BlockHashConfig(**{k: v for k, v in kw.items()
                                        if k != "tile_interp"}), \
        tbh.BlockHashConfig(**kw)
    assert tcfg.uses_tile_interp
    x = _points(rng, 128)
    table = _table(rng, tcfg)
    params = serving_params({"table": torch.from_numpy(table)},
                            FieldConfig(block_grid=tcfg))
    assert params["table"].shape == table.shape
    got, _ = tbh.block_hash_encode(torch.from_numpy(x), params["table"], tcfg)
    want, _ = jbh.block_hash_encode(jnp.asarray(x), jnp.asarray(table), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    plain_cfg = tbh.BlockHashConfig(**dict(kw, tile_interp=False))
    with pytest.raises(ValueError, match="master layout"):
        tbh.block_hash_encode(torch.from_numpy(x),
                              tbh.gather_table(torch.from_numpy(table), plain_cfg),
                              tcfg)


@pytest.mark.parametrize("knobs,tol", [
    ({"TENT_KERNEL_REDUCE": "vpu", "TENT_KERNEL_OUT": "float32",
      "TENT_KERNEL_CHUNK": 2048}, 1e-5),
    ({}, 2e-2),  # production defaults: bf16 products + bf16 output
])
def test_encode_matches_jax_tent_kernel(rng, monkeypatch, knobs, tol):
    """Against the JAX fused encode through the Pallas kernel (interpret
    mode), knobs set as tests/test_tent_contract.py sets them."""
    jcfg, tcfg = _configs()
    x = _points(rng, 256)
    table = np.array(jbh.init_block_table(jax.random.PRNGKey(0), jcfg))
    monkeypatch.setattr(jbh, "USE_TENT_KERNEL", True)
    monkeypatch.setattr(jbh, "_FORCE_TENT_KERNEL_INTERPRET", True)
    for k, v in knobs.items():
        monkeypatch.setattr(jbh, k, v)
    want, _ = jbh.block_hash_encode(jnp.asarray(x), jnp.asarray(table), jcfg)
    got, _ = tbh.block_hash_encode(torch.from_numpy(x),
                                   torch.from_numpy(table), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("gather", ["bfloat16", "float32"])
def test_encode_backward_runs_and_gives_no_point_gradient(rng, gather):
    """The table gets an f32 gradient of the master's shape; the points
    get none (the JAX fused VJP's zero dx). A float32 encode refuses
    points that require grad: the JAX float32 encode differentiates them."""
    _, tcfg = _configs(gather=gather)
    table = torch.from_numpy(_table(rng, tcfg)).requires_grad_(True)
    x = torch.from_numpy(_points(rng, 8)).requires_grad_(True)
    if gather == "float32":
        with pytest.raises(NotImplementedError, match="Queue 3"):
            tbh.block_hash_encode(x, table, tcfg)
        x = x.detach()
    feats, _ = tbh.block_hash_encode(x, table, tcfg)
    assert feats.shape == (8, tcfg.out_dim)
    feats.sum().backward()
    assert table.grad.dtype == torch.float32
    assert table.grad.shape == table.shape
    assert float(table.grad.abs().max()) > 0.0
    assert x.grad is None
    with torch.inference_mode():
        again, _ = tbh.block_hash_encode(x, table, tcfg)
    np.testing.assert_array_equal(again.numpy(), feats.detach().numpy())


@pytest.mark.parametrize("block_size", [3, 4])
def test_int8_gather_is_refused(rng, block_size):
    """(Named when the port refused the int8 gather.) The int8 gather's
    pack pass: the packed copy is f32 ``[L*R, lpf, F]`` and holds, bit for
    bit, the rows the JAX ``_gather_rows`` dequantizes after its int8 fetch
    (every row of the table gathered once), levels of different magnitude
    each on their own scale; a packed copy is returned as is, and any other
    gather dtype is still refused."""
    jcfg, tcfg = _configs(block_size, gather="int8")
    table = _table(rng, tcfg) * np.repeat(
        np.float32([1e-4, 3e-2, 1.0, 40.0]), tcfg.rows_per_level)[:, None]
    rows = np.arange(table.shape[0], dtype=np.int32)
    want = np.asarray(jbh._gather_rows(jnp.asarray(table), jnp.asarray(rows),
                                       jcfg))
    packed = tbh.gather_table(torch.from_numpy(table), tcfg)
    assert packed.dtype == torch.float32 and packed.shape == (
        table.shape[0], tcfg.lanes_per_feature, tcfg.n_features_per_level)
    got = unpack_rows(packed).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, table)  # it is quantized
    for lv in range(tcfg.n_levels):
        sl = slice(lv * tcfg.rows_per_level, (lv + 1) * tcfg.rows_per_level)
        step = np.abs(table[sl]).max() / 127.0
        assert len(np.unique(np.round(got[sl] / step))) <= 255
        assert np.abs(got[sl] - table[sl]).max() <= 0.5 * step * (1 + 1e-6)
    assert tbh.gather_table(packed, tcfg) is packed
    with pytest.raises(ValueError, match="gather_dtype 'int4'"):
        tbh.BlockHashConfig((0,) * 3, (1,) * 3, gather_dtype="int4")
