"""Port parity: rays, sampling, occupancy, compositing and whole images."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both_states, configs
from indoor_nerf_tpu.ops.occupancy import occupancy_z_vals as j_occupancy_z_vals
from indoor_nerf_tpu.ops.rays import get_rays as j_get_rays
from indoor_nerf_tpu.ops.sampling import (
    sample_pdf as j_sample_pdf,
    stratified_z_vals as j_stratified_z_vals,
)
from indoor_nerf_tpu.ops.volume import raw2outputs as j_raw2outputs
from indoor_nerf_tpu.render.renderer import render_image as j_render_image
from indoor_nerf_tpu_torch.ops.occupancy import occupancy_z_vals
from indoor_nerf_tpu_torch.ops.rays import get_rays
from indoor_nerf_tpu_torch.ops.sampling import linspace01, sample_pdf, stratified_z_vals
from indoor_nerf_tpu_torch.ops.volume import raw2outputs
from indoor_nerf_tpu_torch.render.renderer import render_image

torch.set_num_threads(1)

T = torch.from_numpy


def test_linspace01_is_jnp_linspace():
    for n in (1, 2, 7, 32, 128):
        np.testing.assert_array_equal(linspace01(n).numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, n)))


def test_get_rays_matches_jax(rng):
    K = np.array([[30.5, 0, 12.0], [0, 31.0, 9.5], [0, 0, 1]], np.float32)
    c2w = rng.standard_normal((3, 4)).astype(np.float32)
    jo, jd = j_get_rays(18, 24, jnp.asarray(K), jnp.asarray(c2w))
    to, td = get_rays(18, 24, T(K), T(c2w))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


def _rays(rng, n):
    near = np.full((n, 1), 2.0, np.float32)
    far = np.full((n, 1), 6.0, np.float32)
    return near, far


def test_stratified_z_vals_matches_jax(rng):
    near, far = _rays(rng, 50)
    for lindisp in (False, True):
        want = j_stratified_z_vals(None, jnp.asarray(near), jnp.asarray(far),
                                   16, perturb=0.0, lindisp=lindisp)
        got = stratified_z_vals(T(near), T(far), 16, lindisp=lindisp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # Injected jitter: the same uniform draws the JAX key produces.
    key = jax.random.PRNGKey(3)
    t_rand = np.array(jax.random.uniform(key, (50, 16)))
    want = j_stratified_z_vals(key, jnp.asarray(near), jnp.asarray(far), 16,
                               perturb=1.0)
    got = stratified_z_vals(T(near), T(far), 16, t_rand=T(t_rand))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_sample_pdf_matches_jax(rng):
    """cumsum order differs (XLA scan vs sequential), so depths agree to
    float32 rounding of the cdf, not bitwise."""
    bins = np.sort(rng.uniform(2.0, 6.0, size=(64, 33)), axis=-1).astype(np.float32)
    weights = rng.exponential(1.0, size=(64, 32)).astype(np.float32)
    weights[:8] = 0.0  # all-empty rays: the 1e-5 floor makes them uniform
    want = j_sample_pdf(None, jnp.asarray(bins), jnp.asarray(weights), 24,
                        det=True)
    got = sample_pdf(T(bins), T(weights), 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    key = jax.random.PRNGKey(7)
    xi = np.array(jax.random.uniform(key, (64, 24)))
    u = ((np.arange(24, dtype=np.float32) + xi) / np.float32(24)).astype(np.float32)
    want = j_sample_pdf(key, jnp.asarray(bins), jnp.asarray(weights), 24,
                        det=False)
    got = sample_pdf(T(bins), T(weights), 24, u=T(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("weighting", ["density", "transmittance"])
@pytest.mark.parametrize("step", [None, 10])  # eval render; inside warmup
def test_occupancy_z_vals_matches_jax(rng, weighting, step):
    jcfg, tcfg, _ = configs()
    joc = dataclasses.replace(jcfg.render.occupancy, weighting=weighting)
    toc = dataclasses.replace(tcfg.render.occupancy, weighting=weighting)
    density = rng.exponential(2.0, size=toc.n_cells).astype(np.float32)
    n = 200
    rays_o = rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32) \
        + np.array([0.0, 0.0, 4.0], np.float32)
    rays_d = rng.standard_normal((n, 3)).astype(np.float32) * 0.2 \
        + np.array([0.0, 0.0, -1.0], np.float32)
    near, far = _rays(rng, n)
    jstep = jnp.asarray(1 << 30 if step is None else step, jnp.int32)
    want = j_occupancy_z_vals(
        jax.random.PRNGKey(0), jnp.asarray(rays_o), jnp.asarray(rays_d),
        jnp.asarray(near), jnp.asarray(far), {"density": jnp.asarray(density)},
        joc, 16, jstep, perturb=0.0)
    got = occupancy_z_vals(T(rays_o), T(rays_d), T(near), T(far),
                           {"density": T(density)}, toc, 16, step)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_raw2outputs_matches_jax(rng):
    raw = rng.standard_normal((64, 16, 4)).astype(np.float32)
    raw[..., 3] *= 3.0
    z = np.sort(rng.uniform(2.0, 6.0, size=(64, 16)), -1).astype(np.float32)
    rays_d = rng.standard_normal((64, 3)).astype(np.float32)
    for white in (False, True):
        want = j_raw2outputs(jnp.asarray(raw), jnp.asarray(z),
                             jnp.asarray(rays_d), white_bkgd=white)
        got = raw2outputs(T(raw), T(z), T(rays_d), white_bkgd=white)
        for k in ("rgb_map", "disp_map", "acc_map", "weights", "depth_map",
                  "sparsity_loss"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    # Injected sigma noise is the JAX raw_noise_std draw.
    key = jax.random.PRNGKey(1)
    noise = np.array(jax.random.normal(key, (64, 16))) * np.float32(0.5)
    want = j_raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rays_d),
                         raw_noise_std=0.5, noise_key=key)
    got = raw2outputs(T(raw), T(z), T(rays_d), sigma_noise=T(noise))
    np.testing.assert_allclose(got["rgb_map"].numpy(),
                               np.asarray(want["rgb_map"]), rtol=1e-5, atol=1e-5)


def test_render_image_matches_jax(rng):
    """The whole flagship serving render (tiny size) on bridged weights, an
    O(1) table (so the rays are far from transparent) and a random
    occupancy grid.

    Tolerance 1e-3 on rgb, acc and depth (depth only where acc > 1e-3: on
    near-transparent rays depth = sum(w z) / acc is ill-conditioned).
    The resampled depths differ by float32 ulps: XLA turns divisions by
    constants into reciprocal multiplies and scans cumsums in another
    order. A sample that an ulp moves across a block face reads another
    tile row — a C0 seam of the encoder — so the bound is looser than the
    ~1e-4 differences seen at this size."""
    jcfg, tcfg, scene = configs()
    jstate, tstate = both_states(jcfg, occ_rng=rng)
    table = 5.0 * rng.standard_normal(jstate["params"]["table"].shape)
    jstate["params"]["table"] = jnp.asarray(table, jnp.float32)
    tstate["params"]["table"] = T(table.astype(np.float32))
    H = W = 24
    focal = scene.hwf[2] * (W / scene.hwf[1])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    c2w = scene.poses[scene.i_test[0]][:3, :4]
    want = j_render_image(jstate["params"], H, W, K, c2w, scene.near,
                          scene.far, jcfg.render, tile_rays=256,
                          occ_state=jstate["occ"])
    got = render_image(tstate["params"], H, W, K, c2w, scene.near, scene.far,
                       tcfg.render, tile_rays=256, occ_state=tstate["occ"])
    assert got["rgb_map"].shape == (H, W, 3) and got["depth_map"].shape == (H, W)
    assert np.all(np.isfinite(got["rgb_map"]))
    assert np.all(np.isfinite(got["depth_map"]))
    assert want["acc_map"].max() > 0.5  # the field is not transparent
    np.testing.assert_allclose(got["rgb_map"], want["rgb_map"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["acc_map"], want["acc_map"], rtol=0,
                               atol=1e-3)
    seen = want["acc_map"] > 1e-3
    np.testing.assert_allclose(got["depth_map"][seen], want["depth_map"][seen],
                               rtol=0, atol=1e-3)
