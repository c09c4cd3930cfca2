"""``lane_select``: the port against the JAX package's, and the CUDA kernels
against their plain versions.

The JAX ``lane_select`` takes no ``interpret`` argument: off the TPU it runs
``jnp.take_along_axis`` and the one-hot masked sum, which is how the JAX
package's own tests run it, and what the port is held against here.

Everything of jax is imported inside a fixture, so that the CUDA tests of
this file also run on a card's machine, which has no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_lane_gather.py
"""

import numpy as np
import pytest
import torch

from indoor_nerf_tpu_torch import ops
from indoor_nerf_tpu_torch.cuda_build import launch_counts, reset_counts
from indoor_nerf_tpu_torch.ops import lane_gather as lg

torch.set_num_threads(1)

T = torch.from_numpy


@pytest.fixture
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from indoor_nerf_tpu.ops.pallas import lane_select

    return jax, jnp, lane_select


def _inputs(seed, N, k, repeats=True):
    """Random values and cotangents; with ``repeats`` the indices are drawn
    with replacement (and row 0 picks one lane k times), else each row
    picks k distinct lanes."""
    rng = np.random.default_rng(seed)
    values = rng.standard_normal((N, lg.LANES)).astype(np.float32)
    g = rng.standard_normal((N, k)).astype(np.float32)
    if repeats:
        idx = rng.integers(0, lg.LANES, size=(N, k)).astype(np.int32)
        idx[0] = 77
    else:
        idx = np.stack([rng.permutation(lg.LANES)[:k] for _ in range(N)]
                       ).astype(np.int32)
    return values, idx, g


# N = 1000 and 2049 are multiples of neither JAX chunk (2048 forward, 512
# backward) nor of the port's 8 rows per block.
@pytest.mark.parametrize("N,k,repeats", [
    (1000, 1, True), (1000, 8, True), (2049, 8, False), (300, 128, True),
    (300, 128, False), (3, 5, True)])
def test_forward_and_gradient_match_jax(jx, N, k, repeats):
    """Forward: a pick, so bit for bit. Gradient: sums of at most k terms in
    another order, 1e-6 relative (and of the largest entry absolute)."""
    jax, jnp, j_lane_select = jx
    values, idx, g = _inputs(N + k, N, k, repeats)
    want = j_lane_select(jnp.asarray(values), jnp.asarray(idx), k)
    want_d = jax.grad(lambda v: jnp.sum(
        j_lane_select(v, jnp.asarray(idx), k) * g))(jnp.asarray(values))
    tv = T(values).requires_grad_(True)
    got = ops.lane_select(tv, T(idx))
    (got_d,) = torch.autograd.grad(got, tv, grad_outputs=T(g))
    assert got.shape == (N, k) and got_d.shape == (N, lg.LANES)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    want_d = np.asarray(want_d)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want_d).max()))
    if repeats:  # row 0 sums its whole cotangent into lane 77
        np.testing.assert_allclose(float(got_d[0, 77]), float(g[0].sum()),
                                   rtol=1e-5, atol=1e-6)


def test_gradient_is_the_scatter_add():
    """The one-hot sum is ``scatter_add_`` along the lanes."""
    _, idx, g = _inputs(1, 500, 8)
    want = torch.zeros(500, lg.LANES).scatter_add_(1, T(idx).long(), T(g))
    torch.testing.assert_close(lg.lane_select_grad(T(idx), T(g)), want,
                               rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_versions():
    values, idx, g = (T(a) for a in _inputs(2, 64, 8))
    reset_counts()
    out = lg.lane_select_fwd(values, idx)
    d = lg.lane_select_grad(idx, g)
    assert [launch_counts()[k] for k in lg.KERNELS] == [0, 0]  # no kernel ran
    assert torch.equal(out, lg.lane_select_plain(values, idx))
    assert torch.equal(d, lg.lane_select_grad_plain(idx, g))


def test_wrappers_reject_what_the_kernels_do_not_take():
    values, idx, g = (T(a) for a in _inputs(3, 16, 8))
    with pytest.raises(TypeError):
        lg.lane_select(values, idx.long())
    with pytest.raises(TypeError):
        lg.lane_select(values.double(), idx)
    with pytest.raises(TypeError):
        lg.lane_select(values[:, :64], idx)
    with pytest.raises(TypeError):
        lg.lane_select(values, torch.zeros((16, 129), dtype=torch.int32))
    with pytest.raises(TypeError):
        lg.lane_select_grad(idx, g[:, :4])
    with pytest.raises(ValueError):
        lg.lane_select(values.to("meta"), idx.to("meta"))
    bad = idx.clone()
    bad[3, 2] = 128
    with pytest.raises(IndexError):
        lg.lane_select(values, bad)
    bad[3, 2] = -1
    with pytest.raises(IndexError):
        lg.lane_select(values, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("N,k,repeats", [
    (262144, 8, True), (100003, 1, True), (4099, 128, True), (4099, 128, False)])
def test_cuda_kernels_match_plain(N, k, repeats):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    values, idx, g = (T(a).cuda() for a in _inputs(4, N, k, repeats))
    values.requires_grad_(True)
    reset_counts()
    out = lg.lane_select(values, idx)
    (d,) = torch.autograd.grad(out, values, grad_outputs=g)
    torch.cuda.synchronize()
    assert [launch_counts()[name] for name in lg.KERNELS] == [1, 1]
    assert torch.equal(out.detach(), lg.lane_select_plain(values.detach(), idx))
    want = lg.lane_select_grad_plain(idx, g)
    torch.testing.assert_close(d, want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    # No atomics: a second launch gives the same bits.
    assert torch.equal(lg.lane_select_grad(idx, g), d)
