"""The tent contraction: plain version against the JAX Pallas kernel, the
packed row layout the kernel reads, and the CUDA kernel against the plain
version.

The JAX comparisons import jax inside a fixture, so that the CUDA test of
this file also runs on a card's machine, which has no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_tent_contract.py
"""

import numpy as np
import pytest
import torch

from indoor_nerf_tpu_torch.cuda_build import launch_counts, reset_counts
from indoor_nerf_tpu_torch.ops import tent_contract as tc

torch.set_num_threads(1)


@pytest.fixture
def jax_tent():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from indoor_nerf_tpu.ops.blockhash import _tent_weights
    from indoor_nerf_tpu.ops.pallas.tent_contract import tent_contract

    return jnp, tent_contract, _tent_weights


def _inputs(seed, side, F, M, n_rows, dtype):
    rng = np.random.default_rng(seed)
    lpf = tc.lanes_per_feature(side)
    table = rng.standard_normal((n_rows, F * lpf)).astype(np.float32)
    flat_row = rng.integers(0, n_rows, size=M).astype(np.int32)
    p = rng.uniform(0.0, side - 1, size=(M, 3)).astype(np.float32)
    # Integer positions and the far face p = side - 1 are where the
    # 8-vertex bracket of the kernel meets the full-lane tent sum.
    k = min(64, M // 2)
    p[:k] = rng.integers(0, side, size=(k, 3)).astype(np.float32)
    p[k:k + 8] = side - 1
    t = torch.from_numpy(table).to(dtype)
    return t, torch.from_numpy(flat_row), torch.from_numpy(p)


def _packed(table, F):
    """The packed copy ``[rows, lpf, F]`` of a master-layout table of any
    dtype (``pack_rows`` itself takes the f32 master)."""
    return tc.pack_rows_plain(table, F, table.dtype)


@pytest.mark.parametrize("side,F,dtype", [
    (4, 4, torch.bfloat16),  # flagship: block_size 3, lpf 64, bf16 table
    (5, 2, torch.float32),   # block_size 4: lpf 128
])
def test_plain_matches_jax_kernel_interpret(jax_tent, side, F, dtype):
    jnp, j_tent_contract, _ = jax_tent
    table, flat_row, p = _inputs(0, side, F, M=3000, n_rows=200, dtype=dtype)
    rows = table.index_select(0, flat_row.long()).to(torch.float32).numpy()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = j_tent_contract(jnp.asarray(rows, jdt), jnp.asarray(p.numpy()),
                           side, F, interpret=True)
    got = tc.tent_contract_plain(table, flat_row, p, side, F)
    assert got.dtype == torch.float32 and got.shape == (3000, F)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("side", [4, 5])
def test_tent_weights_match_jax(jax_tent, side):
    jnp, _, j_tent_weights = jax_tent
    _, _, p = _inputs(1, side, 2, M=500, n_rows=4, dtype=torch.float32)
    lanes = tc.lanes_per_feature(side)
    np.testing.assert_array_equal(
        tc.tent_weights(p, side, lanes).numpy(),
        np.asarray(j_tent_weights(jnp.asarray(p.numpy()), side, lanes)))


def test_cpu_tensors_take_the_plain_version():
    table, flat_row, p = _inputs(2, 4, 4, M=100, n_rows=50,
                                 dtype=torch.bfloat16)
    reset_counts()
    out = tc.tent_contract(_packed(table, 4), flat_row, p, 4, 4)
    assert launch_counts()["tent_contract"] == 0  # no kernel ran
    np.testing.assert_array_equal(
        out.numpy(), tc.tent_contract_plain(table, flat_row, p, 4, 4).numpy())


@pytest.mark.parametrize("side,F,lpf", [
    (4, 4, 64),   # flagship
    (5, 2, 128),  # block_size 4
    (4, 3, 64),   # an odd F: no vector form
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_rows_round_trip(side, F, lpf, dtype):
    """packed[r, lane, f] == master[r, f*lpf + lane], cast as Tensor.to
    casts; un-packing gives the (cast) master back."""
    assert tc.lanes_per_feature(side) == lpf
    rng = np.random.default_rng(5)
    master = torch.from_numpy(
        rng.standard_normal((37, F * lpf)).astype(np.float32))
    packed = tc.pack_rows(master, F, dtype)
    assert packed.shape == (37, lpf, F) and packed.dtype == dtype
    assert packed.is_contiguous()
    for f in range(F):
        np.testing.assert_array_equal(
            packed[:, :, f].float().numpy(),
            master[:, f * lpf:(f + 1) * lpf].to(dtype).float().numpy())
    back = tc.unpack_rows(packed)
    assert back.shape == master.shape and back.dtype == dtype
    np.testing.assert_array_equal(back.float().numpy(),
                                  master.to(dtype).float().numpy())
    with pytest.raises(TypeError):
        tc.pack_rows(master, F, torch.float16)
    with pytest.raises(TypeError):
        tc.pack_rows(master.to(torch.bfloat16), F, torch.bfloat16)


def test_plain_version_takes_both_layouts():
    table, flat_row, p = _inputs(6, 5, 2, M=200, n_rows=30, dtype=torch.float32)
    np.testing.assert_array_equal(
        tc.tent_contract_plain(_packed(table, 2), flat_row, p, 5, 2).numpy(),
        tc.tent_contract_plain(table, flat_row, p, 5, 2).numpy())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    table, flat_row, p = _inputs(3, 4, 4, M=10, n_rows=8, dtype=torch.float32)
    with pytest.raises(ValueError, match="packed"):
        tc.tent_contract(table, flat_row, p, 4, 4)  # the master layout
    table = _packed(table, 4)
    with pytest.raises(ValueError, match="packed"):
        tc.tent_contract(table, flat_row, p, 4, 2)  # another F
    with pytest.raises(TypeError):
        tc.tent_contract(table.to(torch.float16), flat_row, p, 4, 4)
    with pytest.raises(TypeError):
        tc.tent_contract(table, flat_row.long(), p, 4, 4)
    with pytest.raises(ValueError):
        tc.tent_contract(table, flat_row, p[:, :2], 4, 4)
    with pytest.raises(ValueError):
        tc.tent_contract(table, flat_row, p, 5, 4)  # 125 vertices > 64 lanes
    with pytest.raises(ValueError):
        tc.tent_contract(table.to("meta"), flat_row.to("meta"),
                         p.to("meta"), 4, 4)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("side,F,M,n_rows,dtype", [
    (4, 4, 262144, 65536, torch.bfloat16),  # flagship table, M = 2^18
    (5, 2, 100003, 4096, torch.float32),    # block_size 4, F 2 f32, ragged M
    (4, 4, 12345, 512, torch.bfloat16),     # M not a multiple of the block
    (4, 2, 30000, 512, torch.bfloat16),     # one 4-byte vector per vertex
    (4, 3, 30000, 512, torch.float32),      # odd F: scalar loads
    (4, 8, 40000, 512, torch.bfloat16),     # two vectors per vertex
])
def test_cuda_kernel_matches_plain(side, F, M, n_rows, dtype):
    """Integer positions and p = side - 1 are among ``_inputs``' rows."""
    _need_card()
    table, flat_row, p = (t.cuda() for t in
                          _inputs(4, side, F, M, n_rows, dtype))
    reset_counts()
    got = tc.tent_contract(_packed(table, F), flat_row, p, side, F)
    torch.cuda.synchronize()
    assert launch_counts()["tent_contract"] == 1
    want = tc.tent_contract_plain(table, flat_row, p, side, F)
    assert got.dtype == torch.float32 and got.shape == (M, F)
    # f32 accumulation on both sides; only the summation order differs.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side,F", [(4, 4), (5, 2), (4, 3)])
def test_cuda_pack_kernel_matches_plain(side, F, dtype):
    _need_card()
    lpf = tc.lanes_per_feature(side)
    master = torch.randn((1031, F * lpf),
                         generator=torch.Generator().manual_seed(0)).cuda()
    got = tc.pack_rows(master, F, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, tc.pack_rows_plain(master, F, dtype))


def _int8_master(F, lpf, n_levels=4, rows_per_level=257):
    """A master table whose levels differ in magnitude by 10^6, with exact
    halves of each level's int8 step among its entries (round half to
    even decides them)."""
    g = torch.Generator().manual_seed(1)
    t = torch.randn((n_levels * rows_per_level, F * lpf), generator=g)
    t *= torch.tensor([1e-4, 1e-2, 1.0, 1e2]).repeat_interleave(
        rows_per_level)[:, None]
    scale = tc.int8_level_scales(t, n_levels)
    t[1::7, 3] = (torch.arange(1, t[1::7].shape[0] + 1) % 5 + 0.5) * \
        scale.repeat_interleave(rows_per_level)[1::7]
    return t


def test_int8_pack_plain_rounds_half_to_even():
    """The plain int8 pack: each level on its own scale, halves to even,
    every entry within half a step, packed f32 as ``pack_rows_plain``
    packs the dequantized master."""
    F, lpf = 2, 128
    t = _int8_master(F, lpf)
    scale = tc.int8_level_scales(t, 4).repeat_interleave(257)[:, None]
    deq = tc.dequantize_int8_plain(t, 4)
    r = t / scale
    half = r - torch.floor(r) == 0.5
    assert int(half.sum()) > 100
    assert bool((torch.round(r[half]) % 2 == 0).all())
    assert torch.equal(deq, torch.round(r) * scale)
    assert float(torch.round(r).abs().max()) <= 127
    assert float(((deq - t).abs() / scale).max()) <= 0.5 * (1 + 1e-6)
    packed = tc.pack_rows_int8(t, F, 4)
    assert torch.equal(packed, tc.pack_rows_plain(deq, F, torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("side,F", [(4, 4), (5, 2), (4, 3)])
def test_cuda_int8_pack_kernel_matches_plain(side, F):
    """The int8 gather's pack pass on the card, bit for bit its plain form
    (IEEE division and product, rounding half to even on both sides)."""
    _need_card()
    lpf = tc.lanes_per_feature(side)
    master = _int8_master(F, lpf)
    got = tc.pack_rows_int8(master.cuda(), F, 4)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (4 * 257, lpf, F)
    assert torch.equal(got.cpu(), tc.pack_rows_int8_plain(master, F, 4))


@pytest.mark.cuda
def test_cuda_int8_pack_at_the_flagship_table():
    """The flagship's [65536, 256] table (8 levels, F 4, lpf 64): the card's
    int8 pack bit for bit the plain form on the card."""
    _need_card()
    master = torch.randn((65536, 256), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(2))
    master *= torch.logspace(-4, 1, 8, device="cuda").repeat_interleave(
        8192)[:, None]
    got = tc.pack_rows_int8(master, 4, 8)
    want = tc.pack_rows_plain(tc.dequantize_int8_plain(master, 8), 4,
                              torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_out_of_range_row_gives_nan_and_spares_the_rest():
    _need_card()
    table, flat_row, p = (t.cuda() for t in
                          _inputs(7, 4, 4, 4096, 64, torch.bfloat16))
    flat_row[17], flat_row[1000] = 64, -1
    got = tc.tent_contract(_packed(table, 4), flat_row, p, 4, 4)
    torch.cuda.synchronize()
    bad = torch.zeros(4096, dtype=torch.bool, device="cuda")
    bad[17] = bad[1000] = True
    assert bool(torch.isnan(got[bad]).all())
    flat_row[bad] = 0
    want = tc.tent_contract_plain(table, flat_row, p, 4, 4)
    torch.testing.assert_close(got[~bad], want[~bad], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_kernel_on_the_serving_path_stream():
    """The rows and positions of a real serving render (runs of samples in
    one cell along each ray), in the order the encode gives them."""
    _need_card()
    from indoor_nerf_tpu_torch.path_streams import serving_stream

    _, flat_row, p, side, F = serving_stream(torch.device("cuda:0"))
    assert flat_row.shape[0] == 16000 * 32 * 8 and (side, F) == (4, 4)
    master = torch.randn((65536, 256), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    table = tc.pack_rows(master, F, torch.bfloat16)
    got = tc.tent_contract(table, flat_row, p, side, F)
    want = tc.tent_contract_plain(master.to(torch.bfloat16), flat_row, p, side, F)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
