"""NDC rays (LLFF forward-facing scenes) in the port against the JAX package:
the projection, a test-mode render of an LLFF scene, and one training step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both_states, check_train_step_matches_jax, configs
from indoor_nerf_tpu.ops.rays import ndc_rays as j_ndc_rays
from indoor_nerf_tpu.render.renderer import render_image as j_render_image
from indoor_nerf_tpu_torch.data.scene_files import make_plane_scene, write_llff_scene
from indoor_nerf_tpu_torch.ops.rays import ndc_rays
from indoor_nerf_tpu_torch.render.renderer import render_image
from indoor_nerf_tpu_torch.train.step import TrainConfig, init_train_state, train_step
from test_torch_train_step import f32_scatter  # noqa: F401  (fixture)


@pytest.fixture(scope="module")
def llff_flags(tmp_path_factory):
    """The flagship preset at test size on a 16-view plane scene (24x32
    views in images_8/), NDC on, sigma noise as in configs/fern_tpu.txt."""
    root = str(tmp_path_factory.mktemp("llff"))
    write_llff_scene(root, make_plane_scene(16), 192, 256, 240.0, 8)
    return ["--flagship", "--dataset_type", "llff", "--datadir", root,
            "--use_viewdirs", "--n_levels", "4", "--finest_res", "32",
            "--log2_hashmap_size", "12", "--occ_resolution", "16",
            "--occ_candidates", "32", "--occ_samples", "8",
            "--raw_noise_std", "1"]


def test_ndc_rays_matches_jax():
    rng = np.random.default_rng(0)
    rays_o = (rng.normal(size=(500, 3)) * 0.2).astype(np.float32)
    rays_d = rng.normal(size=(500, 3)).astype(np.float32)
    rays_d[:, 2] = -np.abs(rays_d[:, 2]) - 0.5  # forward: down -z
    want = j_ndc_rays(30, 40, 35.0, 1.0, jnp.asarray(rays_o), jnp.asarray(rays_d))
    got = ndc_rays(30, 40, 35.0, 1.0, torch.from_numpy(rays_o),
                   torch.from_numpy(rays_d))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()))


def test_llff_config_is_ndc(llff_flags):
    jcfg, tcfg, scene = configs(llff_flags)
    assert scene.ndc and tcfg.render.ndc and jcfg.render.ndc
    assert tcfg.ndc_hwf == jcfg.ndc_hwf == (24, 32, 30.0)
    assert (tcfg.near, tcfg.far) == (0.0, 1.0)
    assert tcfg.render.field.block_grid.bbox_min == \
        jcfg.render.field.block_grid.bbox_min
    _, no_ndc, _ = configs(llff_flags + ["--no_ndc"])
    assert not no_ndc.render.ndc and no_ndc.ndc_hwf is None


def test_ndc_render_matches_jax(llff_flags):
    """A test-mode render of a held-out view, on the JAX initial weights
    with a table of N(0, 0.1) entries and a random occupancy grid: rgb
    within 1e-4."""
    rng = np.random.default_rng(1)
    jcfg, tcfg, scene = configs(llff_flags)
    jstate, tstate = both_states(jcfg, occ_rng=rng)
    table = (0.1 * rng.standard_normal(jstate["params"]["table"].shape)
             ).astype(np.float32)
    jstate["params"]["table"] = jnp.asarray(table)
    tstate["params"]["table"] = torch.from_numpy(table)
    H, W, _ = scene.hwf
    c2w = scene.poses[scene.i_test[0]][:3, :4]
    want = j_render_image(jstate["params"], H, W, scene.K, c2w, scene.near,
                          scene.far, jcfg.render, tile_rays=256,
                          occ_state=jstate["occ"])
    got = render_image(tstate["params"], H, W, scene.K, c2w, scene.near,
                       scene.far, tcfg.render, tile_rays=256,
                       occ_state=tstate["occ"])
    assert np.all(np.isfinite(got["rgb_map"]))
    assert float(np.std(want["rgb_map"])) > 1e-3  # not a flat image
    np.testing.assert_allclose(got["rgb_map"], want["rgb_map"], rtol=0,
                               atol=1e-4)


def test_ndc_train_step_matches_jax(llff_flags, f32_scatter):  # noqa: F811
    """One step of both packages on world rays that each step projects into
    NDC (viewdirs from the world rays), with the JAX draws, the sigma noise
    included: the tolerances of test_train_step_matches_jax."""
    check_train_step_matches_jax(llff_flags)


def test_ndc_step_needs_ndc_hwf(llff_flags):
    _, tcfg, _ = configs(llff_flags)
    cfg = TrainConfig(render=tcfg.render, near=0.0, far=1.0, n_rand=4)
    state = init_train_state(torch.Generator().manual_seed(0), cfg)
    batch = {"rays_o": torch.zeros(4, 3), "target": torch.zeros(4, 3),
             "rays_d": torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)}
    with pytest.raises(ValueError, match="ndc_hwf"):
        train_step(state, batch, cfg, torch.Generator().manual_seed(1))
