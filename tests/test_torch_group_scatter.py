"""The grouped table scatter: plain version against the JAX group sum and
ragged Pallas kernel, and the CUDA kernel against the plain version.

The JAX comparisons import jax inside a fixture, so that the CUDA tests of
this file also run on a card's machine, which has no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_group_scatter.py
"""

import numpy as np
import pytest
import torch

from indoor_nerf_tpu_torch.cuda_build import launch_counts, reset_counts
from indoor_nerf_tpu_torch.ops import blockhash
from indoor_nerf_tpu_torch.ops import group_scatter as gs
from indoor_nerf_tpu_torch.ops.table_scatter import table_scatter, table_scatter_plain
from indoor_nerf_tpu_torch.ops.tent_contract import lanes_per_feature

torch.set_num_threads(1)


@pytest.fixture
def jax_ragged():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from indoor_nerf_tpu.ops.blockhash import BlockHashConfig, _cot_rows
    from indoor_nerf_tpu.ops.pallas.table_scatter import scatter_add_table_ragged

    return jnp, BlockHashConfig, _cot_rows, scatter_add_table_ragged


def _inputs(seed, side, F, Rn, S, groups, R, one_row=False, nonneg=False):
    """(g [Rn, S, L*F], row [Rn, S, L], p [Rn, S, L, 3]): every member of a
    group carries its group's random anchor row; positions cover the tent
    kinks (integer p) and the far face p = side - 1."""
    rng = np.random.default_rng(seed)
    L = len(groups)
    g = rng.standard_normal((Rn, S, L * F)).astype(np.float32)
    if nonneg:
        g = np.abs(g)
    p = rng.uniform(0.0, side - 1, size=(Rn, S, L, 3)).astype(np.float32)
    flat = p.reshape(-1, 3)
    k = min(256, flat.shape[0] // 4)
    flat[:k] = rng.integers(0, side, size=(k, 3)).astype(np.float32)
    flat[k:2 * k] = side - 1
    row = np.zeros((Rn, S, L), np.int64)
    for l, G in enumerate(groups):
        anchors = (np.zeros((Rn, S // G), np.int64) if one_row
                   else rng.integers(0, R, (Rn, S // G)))
        row[:, :, l] = np.repeat(anchors, G, axis=1) + l * R
    return (torch.from_numpy(g), torch.from_numpy(row.astype(np.int32)),
            torch.from_numpy(p))


def _jax_ragged_grad(jax_ragged, g, row, p, groups, side, R, dtype):
    """The JAX grouped backward's pieces for these inputs, built as
    ``_encode_grouped_fused_bwd`` builds them (ops/blockhash.py:847-915:
    per class, per-sample cotangent rows, group sum in f32, the cast,
    level-major segments padded to the chunk), through the ragged kernel
    in interpret mode."""
    jnp, BlockHashConfig, j_cot_rows, j_ragged = jax_ragged
    Rn, S, L = row.shape
    F = g.shape[-1] // L
    cfg = BlockHashConfig((0,) * 3, (1,) * 3, n_levels=L, n_features_per_level=F,
                          block_size=side - 1)
    dt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    g, row, p = (jnp.asarray(t.numpy()) for t in (g, row, p))
    chunk = 128
    segs, locs, level_rows = [], [], []
    l0 = 0
    while l0 < L:  # contiguous classes of equal G, as _grouped_classes
        G = groups[l0]
        l1 = l0
        while l1 < L and groups[l1] == G:
            l1 += 1
        Lc, SG = l1 - l0, S // G
        g_c = g[..., l0 * F:l1 * F]
        pt = p[:, :, l0:l1].reshape(Rn, SG, G, Lc, 3).transpose(0, 1, 3, 2, 4)
        gt = g_c.reshape(Rn, SG, G, Lc, F).transpose(0, 1, 3, 2, 4)
        cot_s = j_cot_rows(pt.reshape(-1, 3), gt.reshape(-1, F), cfg)
        W = cot_s.shape[1]
        cot = cot_s.reshape(Rn * SG * Lc, G, W).sum(axis=1).astype(dt)
        flat_row = row[:, ::G, l0:l1].reshape(-1)
        N_c = Rn * SG
        n_pad = -(-N_c // chunk) * chunk
        cotT = jnp.moveaxis(cot.reshape(N_c, Lc, W), 1, 0)
        loc = (flat_row.reshape(N_c, Lc)
               - (l0 + jnp.arange(Lc, dtype=flat_row.dtype))[None] * R).T
        cotT = jnp.pad(cotT, ((0, 0), (0, n_pad - N_c), (0, 0)))
        loc = jnp.pad(loc, ((0, 0), (0, n_pad - N_c)))
        segs.append(cotT.reshape(Lc * n_pad, W))
        locs.append(loc.reshape(-1))
        level_rows += [n_pad] * Lc
        l0 = l1
    out = j_ragged(jnp.concatenate(segs, 0), jnp.concatenate(locs, 0),
                   tuple(level_rows), R, chunk=chunk, interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("groups", [(2, 2, 1, 1), (4, 4, 2, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R", [128, 8])  # R = 8: every row takes many hits
def test_plain_matches_jax_ragged_interpret(jax_ragged, groups, dtype, R):
    """The group sums in f32 and their rounding are the JAX ones (members
    summed in member order on both sides, so bitwise); the table sums are
    f32 on both sides in another order: 1e-5."""
    side, F, Rn, S = 4, 4, 24, 8
    g, row, p = _inputs(0, side, F, Rn, S, groups, R)
    want = _jax_ragged_grad(jax_ragged, g, row, p, groups, side, R, dtype)
    got = gs.group_scatter(g, row, p, groups, len(groups) * R, side, 64, dtype)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(np.abs(want).max()) > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_g1_is_table_scatter():
    """Every G = 1: the per-sample scatter, the same entries in one order."""
    side, F, Rn, S, groups, R = 4, 4, 16, 6, (1, 1, 1), 32
    g, row, p = _inputs(1, side, F, Rn, S, groups, R)
    got = gs.group_scatter(g, row, p, groups, 3 * R, side, 64, torch.bfloat16)
    want = table_scatter_plain(g.reshape(-1, F), p.reshape(-1, 3),
                               row.reshape(-1), 3 * R, side, 64, torch.bfloat16)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_members_are_summed_before_the_rounding():
    """Two members whose bf16-rounded entries sum to another value than
    their rounded f32 sum: the gradient holds the latter."""
    side, groups = 4, (2,)
    g = torch.tensor([[[1.0], [2.0 ** -9]]])  # [1, 2, 1]: F = 1
    p = torch.zeros((1, 2, 1, 3))  # both at vertex (0, 0, 0): weight 1
    row = torch.zeros((1, 2, 1), dtype=torch.int32)
    got = gs.group_scatter(g, row, p, groups, 1, side, 64, torch.bfloat16)
    # 1 + 2^-9 rounds to 1 in bf16 (8 significant bits); 2^-9 alone is exact.
    assert float(got[0, 0]) == 1.0
    per_member = table_scatter_plain(g.reshape(2, 1), p.reshape(2, 3),
                                     row.reshape(2), 1, side, 64, torch.bfloat16)
    assert float(per_member[0, 0]) == 1.0 + 2.0 ** -9


def test_cpu_tensors_take_the_plain_version():
    g, row, p = _inputs(2, 4, 4, 8, 4, (2, 1), 16)
    reset_counts()
    out = gs.group_scatter(g, row, p, (2, 1), 32, 4, 64, torch.bfloat16)
    assert launch_counts()["group_scatter"] == 0  # no kernel ran
    np.testing.assert_array_equal(
        out.numpy(),
        gs.group_scatter_plain(g, row, p, (2, 1), 32, 4, 64,
                               torch.bfloat16).numpy())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    g, row, p = _inputs(3, 4, 4, 4, 4, (2, 1), 8)
    ok = dict(groups=(2, 1), n_rows=16, side=4, lpf=64)

    def call(g=g, row=row, p=p, dtype=torch.float32, **kw):
        return gs.group_scatter(g, row, p, dtype=dtype, **{**ok, **kw})

    call()
    with pytest.raises(TypeError):
        call(dtype=torch.float16)
    with pytest.raises(TypeError):
        call(g=g.double())
    with pytest.raises(TypeError):
        call(row=row.long())
    with pytest.raises(TypeError):
        call(g=g[..., :7])  # not L * F features
    with pytest.raises(ValueError):
        call(p=p[..., :2])
    with pytest.raises(ValueError):
        call(groups=(3, 1))  # 3 does not divide S = 4
    with pytest.raises(ValueError):
        call(groups=(2,))
    with pytest.raises(ValueError):
        call(side=5)  # 125 vertices > 64 lanes
    with pytest.raises(ValueError):
        call(g=g.to("meta"), row=row.to("meta"), p=p.to("meta"))


def test_count_group_reductions_by_hand():
    """The model of the kernel's merge: a vertex that two members of a group
    bracket takes one reduction, with both shares in it."""
    from indoor_nerf_tpu_torch.path_streams import count_group_reductions, count_reductions

    side, lpf, F = 4, 64, 4
    # Brackets at origins (0,0,0) and (1,0,0): they share the 4 vertices of
    # the face x = 1, so the union holds 12 vertices, not 16.
    p = torch.tensor([[0.5, 0.5, 0.5], [1.5, 0.5, 0.5]]).reshape(1, 2, 1, 3)
    g = torch.ones((1, 2, F))
    assert count_group_reductions(g, p, (2,), side, lpf, torch.bfloat16) == \
        (12 * F, 12)
    # Ungrouped, each member takes its own 8: count_reductions' numbers.
    assert count_group_reductions(g, p, (1,), side, lpf, torch.bfloat16) == \
        count_reductions(g.reshape(2, F), p.reshape(2, 3), side,
                         torch.bfloat16) == (16 * F, 16)
    # Shares that cancel leave nothing to add: equal positions, opposite g.
    same = p[:, :1].expand(1, 2, 1, 3).contiguous()
    opposite = torch.tensor([1.0, -1.0]).reshape(1, 2, 1).expand(1, 2, F)
    assert count_group_reductions(opposite.contiguous(), same, (2,), side, lpf,
                                  torch.float32) == (0, 0)
    # Two levels, F = 2 (one vector of 2): level 0 merges, level 1 does not.
    p2 = p.expand(1, 2, 2, 3).contiguous()
    assert count_group_reductions(torch.ones((1, 2, 4)), p2, (2, 1), side, lpf,
                                  torch.float32) == ((12 + 16) * 2, 12 + 16)


def test_anchored_form_is_the_cards():
    """The anchored form has no plain version of its own signature: CPU
    tensors are refused with a pointer to ``grouped_scatter_plain``, after
    the same checks the kernel's launch relies on."""
    g, row, _ = _inputs(5, 4, 4, 4, 4, (2, 1), 8)
    v0 = torch.zeros((4, 4, 2, 3), dtype=torch.int32)
    w = torch.zeros((4, 4, 2, 3))
    ids = torch.arange(2)
    args = dict(groups=(2, 1), n_rows=16, side=4, lpf=64,
                dtype=torch.float32, log2_rows=3,
                primes=blockhash._BLOCK_PRIMES)
    with pytest.raises(ValueError, match="grouped_scatter_plain"):
        gs.group_scatter_anchored(g, v0, w, ids, **args)
    with pytest.raises(ValueError, match="grouped_scatter_plain"):
        gs.anchor_coords(v0, w, ids, (2, 1), 4, 3, blockhash._BLOCK_PRIMES)
    with pytest.raises(TypeError):
        gs.group_scatter_anchored(g, v0.long(), w, ids, **args)
    with pytest.raises(TypeError):
        gs.group_scatter_anchored(g, v0, w, ids.int(), **args)
    with pytest.raises(ValueError):
        gs.group_scatter_anchored(g, v0, w[:, :2], ids, **args)
    with pytest.raises(ValueError):
        gs.group_scatter_anchored(g, v0, w, ids, **{**args, "log2_rows": 32})
    with pytest.raises(ValueError):
        gs.group_scatter_anchored(g, v0, w, ids, **{**args, "primes": (1, 2)})


def _cuda_case(side, F, Rn, S, groups, R, dtype, one_row):
    g, row, p = (t.cuda() for t in _inputs(4, side, F, Rn, S, groups, R,
                                           one_row, nonneg=one_row))
    lpf = lanes_per_feature(side)
    n_rows = len(groups) * R
    reset_counts()
    got = gs.group_scatter(g, row, p, groups, n_rows, side, lpf, dtype)
    torch.cuda.synchronize()
    assert launch_counts()["group_scatter"] == 1
    want = gs.group_scatter_plain(g, row, p, groups, n_rows, side, lpf, dtype)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("side,F,Rn,S,groups,R,dtype,one_row", [
    # the flagship grouped step: 4096 rays x 32 samples, 3 classes
    (4, 4, 4096, 32, (4, 4, 2, 2, 1, 1, 1, 1), 8192, torch.bfloat16, False),
    (5, 2, 1000, 12, (3, 3, 2, 2, 1, 1, 1, 1), 4096, torch.float32, False),
    (4, 4, 512, 32, (4, 4, 2, 2, 1, 1, 1, 1), 8192, torch.bfloat16, True),
])
def test_cuda_kernel_matches_plain(side, F, Rn, S, groups, R, dtype, one_row):
    """Both form the same rounded group sums (members in member order, no
    FMA contraction in the kernel) and add them in f32, in orders that
    change from run to run: 1e-4 relative, and 1e-6 of the largest entry
    absolute. The one-row case takes non-negative cotangents, so its sums
    of ~10^4 terms do not cancel and stay within that relative bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    got, want = _cuda_case(side, F, Rn, S, groups, R, dtype, one_row)
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = float(want.abs().max())
    assert scale > 0.0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * scale)


def _lattice(seed, block_size, F, dtype, groups, Rn, S, reach):
    """(config, g, v0, w, level_ids) on the card: the lattice coordinates of
    sorted samples along ``Rn`` random rays of length ``reach`` through an
    8-level grid, and a random cotangent."""
    rng = np.random.default_rng(seed)
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    cfg = blockhash.BlockHashConfig(
        bbox_min=(-1.0, -1.2, -0.8), bbox_max=(1.1, 1.0, 1.3), n_levels=8,
        n_features_per_level=F, log2_rows=10, base_resolution=16,
        finest_resolution=512, block_size=block_size, gather_dtype=name,
        scatter_dtype=name, ray_groups=groups)
    o = rng.uniform(-0.9, 0.9, size=(Rn, 1, 3))
    d = rng.standard_normal((Rn, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(0.0, reach, size=(Rn, S, 1)), axis=1)
    pts = torch.from_numpy((o + t * d).astype(np.float32)).cuda()
    v0, w, level_ids, _ = blockhash._vertex_coords(pts.reshape(-1, 3), cfg,
                                                   np.arange(8))
    g = torch.from_numpy(rng.standard_normal((Rn, S, 8 * F)).astype(np.float32))
    return (cfg, g.cuda(), v0.reshape(Rn, S, 8, 3), w.reshape(Rn, S, 8, 3),
            level_ids)


@pytest.mark.cuda
@pytest.mark.parametrize("block_size,F,dtype,groups,reach", [
    (3, 4, torch.bfloat16, (4, 4, 2, 2, 1, 1, 1, 1), 0.8),  # the flagship's
    (4, 2, torch.float32, (4, 4, 2, 2, 1, 1, 1, 1), 0.8),  # side 5, lpf 128
    # G 4 at the finest levels too, on long rays: most members lie outside
    # their anchor's block and are clamped onto its faces, where several
    # bracket the same vertices with different weights.
    (3, 4, torch.bfloat16, (4,) * 8, 2.5),
])
def test_cuda_anchored_form_matches_coords_and_plain(block_size, F, dtype,
                                                     groups, reach):
    """The kernel with the anchor math inside: its rows and positions are
    bit for bit ``_grouped_coords``' (integer math, one f32 add), and its
    table gradient is the plain version's at the scatter's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    Rn, S = 1024, 32
    cfg, g, v0, w, level_ids = _lattice(6, block_size, F, dtype, groups, Rn, S,
                                        reach)
    n_rows = 8 * cfg.rows_per_level
    row, p = blockhash._grouped_coords(v0, w, level_ids, cfg, groups)
    k_row, k_p = gs.anchor_coords(v0, w, level_ids, groups, cfg.side,
                                  cfg.log2_rows, blockhash._BLOCK_PRIMES)
    assert torch.equal(k_row, row) and torch.equal(k_p, p)
    on_face = ((p == 0) | (p == block_size)).any(-1).float().mean()
    assert float(on_face) > (0.5 if reach > 1 else 0.0)
    reset_counts()
    got = blockhash.grouped_scatter(g, v0, w, level_ids, cfg, groups, n_rows)
    torch.cuda.synchronize()
    assert launch_counts()["group_scatter"] == 1
    want = blockhash.grouped_scatter_plain(g, v0, w, level_ids, cfg, groups,
                                           n_rows)
    scale = float(want.abs().max())
    assert scale > 0.0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * scale)
    # The given form on those rows and positions: the same merge body.
    given = gs.group_scatter(g, row, p, groups, n_rows, cfg.side,
                             cfg.lanes_per_feature, dtype)
    torch.testing.assert_close(given, want, rtol=1e-4, atol=1e-6 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("side,F,dtype", [(4, 4, torch.bfloat16),
                                          (5, 2, torch.float32),
                                          (4, 3, torch.bfloat16)])
def test_cuda_one_group_per_row_is_bitwise_plain(side, F, dtype):
    """Every table row takes exactly one group, so no sum depends on the
    order of the reductions: the kernel's merged entries (members in member
    order, one rounding) must equal the plain version's bit for bit. The
    members of a group lie near each other, so their brackets overlap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    rng = np.random.default_rng(7)
    Rn, S, groups = 256, 12, (4, 3, 2, 1)
    L, lpf = len(groups), lanes_per_feature(side)
    R = Rn * S  # rows per level: one for every group of every level
    g = rng.standard_normal((Rn, S, L * F)).astype(np.float32)
    row = np.zeros((Rn, S, L), np.int64)
    p = np.zeros((Rn, S, L, 3), np.float32)
    for l, G in enumerate(groups):
        n = Rn * S // G
        ids = rng.permutation(R)[:n].reshape(Rn, S // G)
        row[:, :, l] = np.repeat(ids, G, axis=1) + l * R
        centre = rng.uniform(0.0, side - 1, size=(Rn, S // G, 1, 3))
        walk = rng.uniform(-0.7, 0.7, size=(Rn, S // G, G, 3))
        p[:, :, l] = np.clip(centre + walk, 0.0, side - 1).reshape(Rn, S, 3)
    p.reshape(-1, 3)[:64] = np.round(p.reshape(-1, 3)[:64])  # tent kinks
    g, row, p = (torch.from_numpy(a).cuda() for a in (g, row.astype(np.int32), p))
    got = gs.group_scatter(g, row, p, groups, L * R, side, lpf, dtype)
    want = gs.group_scatter_plain(g, row, p, groups, L * R, side, lpf, dtype)
    torch.cuda.synchronize()
    assert float(want.abs().max()) > 0.0
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
def test_cuda_all_g1_is_table_scatter():
    """Every G = 1: the kernel adds what ``table_scatter``'s kernel adds,
    entry for entry, in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    side, F, Rn, S, groups, R = 4, 4, 2048, 32, (1,) * 8, 8192
    g, row, p = (t.cuda() for t in _inputs(8, side, F, Rn, S, groups, R))
    got = gs.group_scatter(g, row, p, groups, 8 * R, side, 64, torch.bfloat16)
    want = table_scatter(g.reshape(-1, F), p.reshape(-1, 3), row.reshape(-1),
                         8 * R, side, 64, torch.bfloat16)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * scale)
