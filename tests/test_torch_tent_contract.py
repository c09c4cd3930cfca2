"""The tent contraction: plain version against the JAX Pallas kernel, and
the CUDA kernel against the plain version.

The JAX comparisons import jax inside a fixture, so that the CUDA test of
this file also runs on a card's machine, which has no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_tent_contract.py
"""

import numpy as np
import pytest
import torch

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
    tc.reset_launch_count()
    out = tc.tent_contract(table, flat_row, p, 4, 4)
    assert tc.launch_count() == 0  # no kernel ran
    np.testing.assert_array_equal(
        out.numpy(), tc.tent_contract_plain(table, flat_row, p, 4, 4).numpy())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    table, flat_row, p = _inputs(3, 4, 4, M=10, n_rows=8, dtype=torch.float32)
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


@pytest.mark.cuda
@pytest.mark.parametrize("side,F,M,n_rows,dtype", [
    (4, 4, 262144, 65536, torch.bfloat16),  # flagship table, M = 2^18
    (5, 2, 100003, 4096, torch.float32),    # block_size 4, ragged M
    (4, 4, 12345, 512, torch.bfloat16),     # M not a multiple of the block
])
def test_cuda_kernel_matches_plain(side, F, M, n_rows, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    table, flat_row, p = (t.cuda() for t in
                          _inputs(4, side, F, M, n_rows, dtype))
    tc.reset_launch_count()
    got = tc.tent_contract(table, flat_row, p, side, F)
    torch.cuda.synchronize()
    assert tc.launch_count() == 1
    want = tc.tent_contract_plain(table, flat_row, p, side, F)
    assert got.dtype == torch.float32 and got.shape == (M, F)
    # f32 accumulation on both sides; only the summation order differs.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
