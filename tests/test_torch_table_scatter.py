"""The table scatter: plain version against the JAX cotangent rows and
Pallas kernel, and the CUDA kernel against the plain version.

The JAX comparisons import jax inside a fixture, so that the CUDA tests of
this file also run on a card's machine, which has no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_table_scatter.py
"""

import shutil

import numpy as np
import pytest
import torch

from indoor_nerf_tpu_torch import cuda_build
from indoor_nerf_tpu_torch.ops import table_scatter as ts
from indoor_nerf_tpu_torch.ops.tent_contract import lanes_per_feature

torch.set_num_threads(1)


@pytest.fixture
def jax_scatter():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from indoor_nerf_tpu.ops.blockhash import BlockHashConfig, _cot_rows
    from indoor_nerf_tpu.ops.pallas.table_scatter import scatter_add_table

    return jnp, BlockHashConfig, _cot_rows, scatter_add_table


def _inputs(seed, side, F, N, L, R, one_row=False, nonneg=False):
    """(g [M, F], p [M, 3], flat_row [M]) with M = N * L rows ordered
    level-minor (m = point * L + level), as the encode makes them."""
    rng = np.random.default_rng(seed)
    M = N * L
    g = rng.standard_normal((M, F)).astype(np.float32)
    if nonneg:
        g = np.abs(g)
    p = rng.uniform(0.0, side - 1, size=(M, 3)).astype(np.float32)
    # Integer positions and the far face p = side - 1: where the 8-lane
    # bracket meets the full-lane tent formula.
    k = min(256, M // 4)
    p[:k] = rng.integers(0, side, size=(k, 3)).astype(np.float32)
    p[k:2 * k] = side - 1
    rows = np.zeros((N, L), np.int64) if one_row else rng.integers(0, R, (N, L))
    flat = (rows + np.arange(L)[None, :] * R).reshape(-1).astype(np.int32)
    return torch.from_numpy(g), torch.from_numpy(p), torch.from_numpy(flat)


@pytest.mark.parametrize("side,F", [(4, 4), (5, 2)])  # flagship; block_size 4
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R", [128, 8])  # R = 8: every row takes ~40 hits
def test_plain_matches_jax_pallas_interpret(jax_scatter, side, F, dtype, R):
    """The rounded cotangent entries are bitwise the JAX ones; the sums
    are f32 on both sides in another order: 1e-5."""
    jnp, BlockHashConfig, j_cot_rows, j_scatter = jax_scatter
    L, N = 4, 300
    lpf = lanes_per_feature(side)
    g, p, flat = _inputs(0, side, F, N, L, R)
    cfg = BlockHashConfig((0,) * 3, (1,) * 3, n_levels=L, n_features_per_level=F,
                          block_size=side - 1)
    j_cot = j_cot_rows(jnp.asarray(p.numpy()), jnp.asarray(g.numpy()), cfg)
    np.testing.assert_array_equal(ts.cot_rows(g, p, side, lpf).numpy(),
                                  np.asarray(j_cot))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = j_scatter(j_cot.astype(jdt), jnp.asarray(flat.numpy()), L, R,
                     chunk=128, interpret=True)
    got = ts.table_scatter(g, p, flat, L * R, side, lpf, dtype)
    assert got.dtype == torch.float32 and got.shape == (L * R, F * lpf)
    assert float(np.abs(np.asarray(want)).max()) > 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_collisions_accumulate_every_entry():
    """Every (point, level) of a level on ONE row: that row's entries are
    the sums over all points (float64 reference of the same f32 entries)."""
    side, F, L, R, N = 4, 4, 2, 16, 500
    g, p, flat = _inputs(1, side, F, N, L, R, one_row=True)
    got = ts.table_scatter(g, p, flat, L * R, side, 64, torch.float32)
    cot = ts.cot_rows(g, p, side, 64).double()
    for level in range(L):
        want = cot[level::L].sum(0)
        np.testing.assert_allclose(got[level * R].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert float(got[level * R + 1:(level + 1) * R].abs().max()) == 0.0


def test_cpu_tensors_take_the_plain_version():
    g, p, flat = _inputs(2, 4, 4, 50, 2, 32)
    ts.reset_launch_count()
    out = ts.table_scatter(g, p, flat, 64, 4, 64, torch.bfloat16)
    assert ts.launch_count() == 0  # no kernel ran
    np.testing.assert_array_equal(
        out.numpy(),
        ts.table_scatter_plain(g, p, flat, 64, 4, 64, torch.bfloat16).numpy())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    g, p, flat = _inputs(3, 4, 4, 10, 2, 8)
    with pytest.raises(TypeError):
        ts.table_scatter(g, p, flat, 16, 4, 64, torch.float16)
    with pytest.raises(TypeError):
        ts.table_scatter(g.double(), p, flat, 16, 4, 64)
    with pytest.raises(TypeError):
        ts.table_scatter(g, p, flat.long(), 16, 4, 64)
    with pytest.raises(ValueError):
        ts.table_scatter(g, p[:, :2], flat, 16, 4, 64)
    with pytest.raises(ValueError):
        ts.table_scatter(g, p, flat, 16, 5, 64)  # 125 vertices > 64 lanes
    with pytest.raises(ValueError):
        ts.table_scatter(g.to("meta"), p.to("meta"), flat.to("meta"), 16, 4, 64)


def test_digest_covers_the_shared_headers(tmp_path):
    """Editing a header that the kernels include changes every kernel's
    digest (so no stale library loads); editing one kernel's source
    changes only its own."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share tent_bracket.cuh"
    before = {n: cuda_build.source_digest(n, csrc)
              for n in ("tent_contract", "table_scatter")}
    assert before["tent_contract"] == cuda_build.source_digest("tent_contract")
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {n: cuda_build.source_digest(n, csrc) for n in before}
    assert all(after[n] != before[n] for n in before)
    src = csrc / "table_scatter.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert cuda_build.source_digest("table_scatter", csrc) != after["table_scatter"]
    assert cuda_build.source_digest("tent_contract", csrc) == after["tent_contract"]


def test_count_reductions_by_hand():
    """The count of what the kernels add, on a stream small enough to
    count by hand."""
    from indoor_nerf_tpu_torch.path_streams import count_reductions

    M, F, side = 128, 4, 4
    g = torch.ones((M, F))
    p = torch.full((M, 3), 1.5)
    # Every entry nonzero: 8 per (row, feature) as scalars, 8 vectors a row.
    assert count_reductions(g, p, side, torch.bfloat16) == (M * F * 8, M * 8)
    # An integer position has one nonzero vertex, and zero rows of g none.
    p[:] = 2.0
    g[: M // 2] = 0.0
    assert count_reductions(g, p, side, torch.float32) == (M // 2 * F, M // 2)
    # F = 6 goes as three 2-vectors per vertex.
    assert count_reductions(torch.ones((M, 6)), p, side, torch.float32) == \
        (M * 6, M * 3)
    # An entry that rounds to zero in bf16 is skipped there, not in f32:
    # 6 units of the smallest f32 denormal, times three weights of 0.5.
    tiny = torch.full((M, F), 6 * 2.0 ** -149)
    p[:] = 1.5
    assert count_reductions(tiny, p, side, torch.bfloat16)[0] == 0
    assert count_reductions(tiny, p, side, torch.float32)[0] == M * F * 8


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _cuda_case(side, F, N, L, R, dtype, one_row):
    g, p, flat = (t.cuda() for t in _inputs(4, side, F, N, L, R, one_row,
                                            nonneg=one_row))
    lpf = lanes_per_feature(side)
    ts.reset_launch_count()
    got = ts.table_scatter(g, p, flat, L * R, side, lpf, dtype)
    torch.cuda.synchronize()
    assert ts.launch_count() == 1
    want = ts.table_scatter_plain(g, p, flat, L * R, side, lpf, dtype)
    return got, want


def _assert_scatter_close(got, want):
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = float(want.abs().max())
    assert scale > 0.0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("side,F,N,L,R,dtype,one_row", [
    (4, 4, 131072, 8, 8192, torch.bfloat16, False),  # flagship, M = 2^20
    (5, 2, 100003, 8, 4096, torch.float32, False),   # block_size 4, ragged M
    (4, 4, 16384, 8, 8192, torch.bfloat16, True),    # every row on one row
])
def test_cuda_kernel_matches_plain(side, F, N, L, R, dtype, one_row):
    """Both sum the same rounded entries in f32 (the plain version with
    index_add_'s atomics), in orders that change from run to run: 1e-4
    relative, and 1e-6 of the largest entry absolute. The one-row case
    takes non-negative cotangents, so its sums of ~10^4 terms do not
    cancel and stay within that relative bound."""
    _need_card()
    got, want = _cuda_case(side, F, N, L, R, dtype, one_row)
    _assert_scatter_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("side,F,N,L,R,dtype", [
    (5, 2, 65536, 16, 4096, torch.float32),  # block_size 4, F 2 f32
    (4, 4, 4099, 8, 64, torch.bfloat16),     # M not a multiple of the block
    (4, 2, 10000, 3, 64, torch.bfloat16),    # 2-vectors, bf16 rounding
    (4, 3, 10000, 3, 64, torch.float32),     # odd F: scalar adds
    (4, 8, 20000, 2, 64, torch.bfloat16),    # two vectors per vertex
])
def test_cuda_kernel_layouts(side, F, N, L, R, dtype):
    """Integer positions and p = side - 1 are among ``_inputs``' rows."""
    _need_card()
    got, want = _cuda_case(side, F, N, L, R, dtype, False)
    _assert_scatter_close(got, want)


def _run_case(brackets):
    """64 points x 2 levels of one row per level, sorted along a 'ray':
    ``brackets`` bracket origins, each held by a run of consecutive points
    (positions differ inside a run): the rows of a ray that stays in one
    cell, whose reductions all land on the same 8 vertices."""
    N, L, F, side, R = 64, 2, 4, 4, 4
    rng = np.random.default_rng(11)
    g = np.abs(rng.standard_normal((N, L, F))).astype(np.float32) + 0.5
    origin = (np.arange(N) * brackets // N) % (side - 1)  # runs of N/brackets
    frac = rng.uniform(0.05, 0.95, size=(N, L, 3)).astype(np.float32)
    p = origin[:, None, None].astype(np.float32) + frac
    flat = np.broadcast_to(np.arange(L, dtype=np.int32) * R, (N, L)).copy()
    return (torch.from_numpy(g.reshape(-1, F)), torch.from_numpy(p.reshape(-1, 3)),
            torch.from_numpy(flat.reshape(-1)), L * R, side, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("brackets", [1, 3, 64])
def test_cuda_runs_round_each_entry_before_the_sum(brackets):
    """Runs of equal rows with equal and with different brackets: every sum
    is the f32 sum of bf16-rounded entries (the plain version), not the
    bf16 rounding of the f32 sum (group_scatter's contract), and brackets
    stay apart."""
    _need_card()
    g, p, flat, n_rows, side, lpf = _run_case(brackets)
    args = (g.cuda(), p.cuda(), flat.cuda(), n_rows, side, lpf)
    got = ts.table_scatter(*args, torch.bfloat16)
    want = ts.table_scatter_plain(*args, torch.bfloat16)
    _assert_scatter_close(got, want)
    # The sum rounded afterwards differs by up to a bf16 half-ulp (2^-9).
    after = ts.table_scatter_plain(*args, torch.float32).to(
        torch.bfloat16).to(torch.float32)
    scale = float(want.abs().max())
    assert float((after - want).abs().max()) > 1e-4 * scale
    assert float((got - want).abs().max()) < \
        0.01 * float((after - want).abs().max())


@pytest.mark.cuda
def test_cuda_out_of_range_rows_are_dropped():
    _need_card()
    g, p, flat = (t.cuda() for t in _inputs(8, 4, 4, 2048, 8, 16))
    bad = torch.zeros(flat.shape[0], dtype=torch.bool, device="cuda")
    bad[5] = bad[3000] = bad[3001] = True
    want = ts.table_scatter_plain(g[~bad], p[~bad], flat[~bad], 128, 4, 64,
                                  torch.bfloat16)
    flat[5], flat[3000], flat[3001] = 128, -1, 1 << 30
    got = ts.table_scatter(g, p, flat, 128, 4, 64, torch.bfloat16)
    _assert_scatter_close(got, want)


@pytest.mark.cuda
def test_cuda_kernel_on_the_training_path_stream():
    """The cotangent, rows and positions of a real flagship training step
    (runs of samples in one cell along each ray, rows of g that are 0)."""
    _need_card()
    from indoor_nerf_tpu_torch.path_streams import count_reductions, training_stream

    args = training_stream(torch.device("cuda:0"))
    g, p, flat, n_rows, side, lpf, dtype = args
    assert (tuple(g.shape), side, lpf, dtype) == \
        ((4096 * 32 * 8, 4), 4, 64, torch.bfloat16)
    _assert_scatter_close(ts.table_scatter(*args),
                          ts.table_scatter_plain(*args))
    scalar, vector = count_reductions(g, p, side, dtype)
    assert 0 < vector <= scalar <= 4 * vector  # one vector per vertex
