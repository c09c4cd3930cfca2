"""Port parity: the level-sharded grid encodes (``parallel/tp.py``), each
model rank's share computed in this process, against JAX ``tp_block_encode``
and ``tp_hash_encode`` on the meshes of tests/test_tp.py and against the
port's single-device encode.

For every model rank j the port's ``*_local`` body encodes levels
``[j*L/m, (j+1)*L/m)`` from its block of the table; the m shares,
concatenated, are the features, and each block's gradient is that block's
slice of the single-device gradient (the backward never leaves the level
owner). The JAX block encode's backward runs its f32-accumulating Pallas
scatter (``_FORCE_PALLAS_SCATTER_INTERPRET``), the port's numerics. The JAX
references are computed once per input set: they do not depend on the
mesh.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import indoor_nerf_tpu.ops.blockhash as jbh
from indoor_nerf_tpu.ops.encoding import (
    HashGridConfig as JHashGridConfig,
    hash_encode as j_hash_encode,
)
from indoor_nerf_tpu.parallel.shard import make_mesh as j_make_mesh
from indoor_nerf_tpu.parallel.tp import (
    table_sharding,
    tp_block_encode as j_tp_block_encode,
    tp_hash_encode as j_tp_hash_encode,
)
from indoor_nerf_tpu_torch.ops import blockhash as tbh
from indoor_nerf_tpu_torch.ops.encoding import HashGridConfig, hash_encode
from indoor_nerf_tpu_torch.parallel.collectives import (
    active_mesh,
    mesh_context,
)
from indoor_nerf_tpu_torch.parallel.shard import Mesh
from indoor_nerf_tpu_torch.parallel.tp import (
    block_tp_context,
    current_block_tp,
    tp_block_encode_local,
    tp_hash_encode_local,
)

torch.set_num_threads(1)
T = torch.from_numpy
MESHES = [(4, 2), (2, 4), (1, 8)]  # tests/test_tp.py:26; all divide 8 levels
N = 64


def _block_configs(dtype, **kw):
    base = dict(bbox_min=(-1.0, -1.2, -0.8), bbox_max=(1.1, 1.0, 1.3),
                n_levels=8, n_features_per_level=4, log2_rows=6,
                base_resolution=4, finest_resolution=64, block_size=3,
                gather_dtype=dtype,
                scatter_dtype="float32" if dtype == "float32" else "bfloat16")
    base.update(kw)
    port = tbh.BlockHashConfig(**base)
    base.pop("tile_interp", None)  # the JAX module global, not a field
    return jbh.BlockHashConfig(**base), port


def _inputs(rng, cfg, width):
    x = rng.uniform(-1.3, 1.4, size=(N, 3)).astype(np.float32)
    table = rng.standard_normal(
        (cfg.n_levels * cfg.rows_per_level, width)).astype(np.float32)
    c = rng.standard_normal((N, cfg.out_dim)).astype(np.float32)
    return x, table, c


@functools.lru_cache(maxsize=None)
def _block_case(dtype):
    """Inputs and the JAX single-device encode's features and gradient of
    <features, c>; JAX's own tests hold ``tp_block_encode`` bit-equal to
    it (tests/test_sharding.py::test_tp_block_encode_matches_single_device),
    and it does not depend on the mesh."""
    jcfg, tcfg = _block_configs(dtype)
    x, table, c = _inputs(np.random.default_rng(11), tcfg,
                          4 * tcfg.lanes_per_feature)
    old = jbh._FORCE_PALLAS_SCATTER_INTERPRET
    jbh._FORCE_PALLAS_SCATTER_INTERPRET = True
    try:
        jf, jkeep = jbh.block_hash_encode(jnp.asarray(x), jnp.asarray(table),
                                          jcfg)
        jg = jax.grad(lambda t: jnp.sum(
            jbh.block_hash_encode(jnp.asarray(x), t, jcfg)[0] * c))(
                jnp.asarray(table))
    finally:
        jbh._FORCE_PALLAS_SCATTER_INTERPRET = old
    return (jcfg, tcfg, x, table, c, np.asarray(jf), np.asarray(jkeep),
            np.asarray(jg))


def _port_shares(local_fn, x, table, c, cfg, m, lp_rows):
    """Each rank's features and its block's gradient of <features_j, c_j>."""
    feats, grads = [], []
    F = cfg.n_features_per_level
    lp = cfg.n_levels // m
    for j in range(m):
        block = T(table[j * lp_rows:(j + 1) * lp_rows].copy())
        block.requires_grad_(True)
        f, keep = local_fn(T(x), block, j, m, cfg)
        assert f.shape == (N, lp * F)
        (g,) = torch.autograd.grad(
            f, block, grad_outputs=T(np.ascontiguousarray(
                c[:, j * lp * F:(j + 1) * lp * F])))
        feats.append(f.detach().numpy())
        grads.append(g.numpy())
    return np.concatenate(feats, 1), np.concatenate(grads, 0), keep.numpy()


def _block_shares(dtype, m):
    jcfg, tcfg, x, table, c, jf, jkeep, jg = _block_case(dtype)
    lp_rows = tcfg.rows_per_level * tcfg.n_levels // m
    return _port_shares(tp_block_encode_local, x, table, c, tcfg, m, lp_rows)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_tp_block_encode_local_matches_jax(shape, dtype):
    """The m shares concatenated: features within 1e-5 of the JAX encode
    and bit for bit the port's single-device encode (one function, on the
    level blocks); each block's gradient its slice of the single-device
    gradient (1e-5 relative), the port's and JAX's."""
    jcfg, tcfg, x, table, c, jf, jkeep, jg = _block_case(dtype)
    got_f, got_g, keep = _block_shares(dtype, shape[1])
    tt = T(table).requires_grad_(True)
    want_f, want_keep = tbh.block_hash_encode(T(x), tt, tcfg)
    (want_g,) = torch.autograd.grad(want_f, tt, grad_outputs=T(c))
    np.testing.assert_array_equal(got_f, want_f.detach().numpy())
    np.testing.assert_array_equal(keep, want_keep.numpy())
    np.testing.assert_allclose(got_g, want_g.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_f, jf, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(keep, jkeep)
    np.testing.assert_allclose(got_g, jg, rtol=1e-5, atol=1e-5)


def test_tp_block_encode_matches_jax_tp_block_encode():
    """Against JAX ``tp_block_encode`` itself on the (4, 2) mesh (bf16, the
    flagship's gather; eager, as JAX's own test runs it: under jit XLA
    reorders the index math and a point moves across a block face)."""
    jcfg, tcfg, x, table, c, *_ = _block_case("bfloat16")
    got_f, _, keep = _block_shares("bfloat16", 2)
    mesh = j_make_mesh(jax.devices(), ("data", "model"), (4, 2))
    jx = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", None)))
    jt = jax.device_put(jnp.asarray(table), table_sharding(mesh))
    jf, jkeep = j_tp_block_encode(jx, jt, jcfg, mesh)
    np.testing.assert_allclose(got_f, np.asarray(jf), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(keep, np.asarray(jkeep))


HASH = dict(bbox_min=(-1.0,) * 3, bbox_max=(1.0,) * 3, n_levels=8,
            log2_hashmap_size=10, base_resolution=16, finest_resolution=128)


@functools.lru_cache(maxsize=None)
def _hash_case():
    jcfg, tcfg = JHashGridConfig(**HASH), HashGridConfig(**HASH)
    rng = np.random.default_rng(12)
    x = rng.uniform(-1.0, 1.0, size=(N, 3)).astype(np.float32)
    table = (rng.standard_normal((8 * tcfg.table_size, 2)) * 1e-2).astype(
        np.float32)
    c = rng.standard_normal((N, 16)).astype(np.float32)
    jf, jkeep = j_hash_encode(jnp.asarray(x), jnp.asarray(table), jcfg)
    jg = jax.grad(lambda t: jnp.sum(
        j_hash_encode(jnp.asarray(x), t, jcfg)[0] * c))(jnp.asarray(table))
    return (jcfg, tcfg, x, table, c, np.asarray(jf), np.asarray(jkeep),
            np.asarray(jg))


@pytest.mark.parametrize("shape", MESHES)
def test_tp_hash_encode_local_matches_jax(shape):
    """The hash grid's shares against the JAX encode (1e-6, as
    tests/test_tp.py holds ``tp_hash_encode`` to it) and the gradient
    against JAX's replicated one
    (tests/test_tp.py::test_tp_encode_gradients_stay_local, 1e-5)."""
    jcfg, tcfg, x, table, c, jf, jkeep, jg = _hash_case()
    got_f, got_g, keep = _port_shares(tp_hash_encode_local, x, table, c,
                                      tcfg, shape[1],
                                      tcfg.table_size * 8 // shape[1])
    want_f, _ = hash_encode(T(x), T(table), tcfg)
    np.testing.assert_array_equal(got_f, want_f.numpy())
    np.testing.assert_allclose(got_f, jf, rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(keep, jkeep)
    np.testing.assert_allclose(got_g, jg, rtol=1e-5, atol=1e-8)


def test_tp_hash_encode_matches_jax_tp_hash_encode():
    jcfg, tcfg, x, table, c, *_ = _hash_case()
    got_f, _, keep = _port_shares(tp_hash_encode_local, x, table, c, tcfg, 2,
                                  tcfg.table_size * 4)
    mesh = j_make_mesh(jax.devices(), ("data", "model"), (4, 2))
    jx = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", None)))
    jt = jax.device_put(jnp.asarray(table), table_sharding(mesh))
    jf, jkeep = j_tp_hash_encode(jx, jt, jcfg, mesh)
    np.testing.assert_allclose(got_f, np.asarray(jf), rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(keep, np.asarray(jkeep))


def test_tp_tile_route_matches_single_device(rng):
    """``--use_pallas`` at the block-hash defaults (block_size 4, f32): each
    rank's share takes the tile route on its block; features and the
    table gradient as the single-device route's."""
    _, tcfg = _block_configs("float32", block_size=4, n_features_per_level=2,
                             tile_interp=True)
    assert tcfg.uses_tile_interp
    m = 2
    x, table, c = _inputs(rng, tcfg, 2 * tcfg.lanes_per_feature)
    lp_rows = tcfg.rows_per_level * tcfg.n_levels // m
    got_f, got_g, _ = _port_shares(tp_block_encode_local, x, table, c, tcfg,
                                   m, lp_rows)
    tt = T(table).requires_grad_(True)
    want_f, _ = tbh.block_hash_encode(T(x), tt, tcfg)
    (want_g,) = torch.autograd.grad(want_f, tt, grad_outputs=T(c))
    np.testing.assert_array_equal(got_f, want_f.detach().numpy())
    np.testing.assert_allclose(got_g, want_g.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arm", [
    {"ray_strides": (1, 1, 1, 1, 2, 2, 4, 4)},
    {"ray_groups": (1, 1, 1, 1, 2, 2, 2, 2)},
])
def test_tp_block_encode_refuses_strided_and_grouped(arm):
    """As JAX tp.py:190-194 (tests/test_tp.py): loudly, never a silent
    unstrided encode."""
    _, tcfg = _block_configs("bfloat16", **arm)
    table = torch.zeros((tcfg.n_levels * tcfg.rows_per_level // 2,
                         4 * tcfg.lanes_per_feature))
    with pytest.raises(NotImplementedError, match="tensor.*parallelism"):
        tp_block_encode_local(torch.zeros((8, 3)), table, 0, 2, tcfg)


def test_tp_refuses_levels_not_divisible():
    _, tcfg = _block_configs("bfloat16")
    with pytest.raises(ValueError, match="not divisible"):
        tp_block_encode_local(torch.zeros((8, 3)), torch.zeros((1, 1)), 0, 3,
                              tcfg)
    hcfg = HashGridConfig(bbox_min=(-1.0,) * 3, bbox_max=(1.0,) * 3,
                          n_levels=8, log2_hashmap_size=10)
    with pytest.raises(ValueError, match="not divisible"):
        tp_hash_encode_local(torch.zeros((8, 3)), torch.zeros((1, 2)), 0, 3,
                             hcfg)


def test_block_tp_context_nests_and_restores():
    """``block_tp_context`` sets the one active mesh; the encodes go
    through TP only where it has a model axis."""
    outer = Mesh(("data", "model"), (2, 2), 0, (0, 0), {})
    data_only = Mesh(("data",), (2,), 0, (0,), {})
    assert current_block_tp() is None and active_mesh() is None
    with block_tp_context(outer):
        assert current_block_tp() is outer and active_mesh() is outer
        with block_tp_context(None):
            assert current_block_tp() is None and active_mesh() is None
        with mesh_context(data_only):
            assert current_block_tp() is None
            assert active_mesh() is data_only
        assert current_block_tp() is outer
    assert current_block_tp() is None and active_mesh() is None
