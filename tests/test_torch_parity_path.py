"""The parity path in the port against the JAX package: the classic NeRF
MLP, the hash-grid and PE fields, the hierarchical ``render_rays``, the
training step of the three parity configurations, a JAX parity checkpoint
imported and rendered, a baked hash-grid field.

Tolerances, each stated where it is held: f32 forwards that differ only in
summation order 1e-5 (of the largest entry where values cross zero); each
step's losses 1e-5 relative; the first step's RAdam moments 1e-4 of each
leaf's largest entry (f32 backward sums in other orders, as the flagship
step's, tests/test_torch_train_step.py) and the parameters after it bit
for bit (RAdam moves none); RAdam's first move from one state: the moments
1e-5 of each leaf's largest, the MLPs 1e-5 relative, the table's entries
by their moments (``_hold_first_move``); after 7 steps the MLPs 1e-5
relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    TINY_FLAGSHIP,
    assert_tree_close,
    both_states,
    both_train_states,
    configs,
    jax_batch_sampler,
    jax_step_draws,
    jax_step_fn,
    jax_train_state_numpy,
)
from indoor_nerf_tpu.models.field import (
    init_field_params as j_init_field_params,
    query_field as j_query_field,
    sigma_query as j_sigma_query,
)
from indoor_nerf_tpu.models.mlp import (
    apply_nerf_big as j_apply_nerf_big,
    init_nerf_big as j_init_nerf_big,
)
from indoor_nerf_tpu.render.renderer import (
    render_image as j_render_image,
    render_rays as j_render_rays,
)
from indoor_nerf_tpu.utils import checkpoint as jckpt
from indoor_nerf_tpu_torch import bridge
from indoor_nerf_tpu_torch.models.field import (
    init_field_params,
    query_field,
    serving_params,
    sigma_query,
)
from indoor_nerf_tpu_torch.models.mlp import NeRFBig, apply_nerf_big
from indoor_nerf_tpu_torch.render import renderer
from indoor_nerf_tpu_torch.render.renderer import render_image, render_rays
from indoor_nerf_tpu_torch.train.step import init_train_state, train_step
from indoor_nerf_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)
T = torch.from_numpy

# The parity CLI at test size: the hash grid of 4 levels x 2 features,
# 2^12 entries per level, 8 coarse + 8 fine samples, sigma noise on.
TINY_PARITY = ["--dataset_type", "synthetic", "--use_viewdirs", "--white_bkgd",
               "--n_levels", "4", "--finest_res", "32", "--log2_hashmap_size",
               "12", "--N_samples", "8", "--N_importance", "8",
               "--raw_noise_std", "1"]
# PE with the classic NeRF, narrowed: 3 x 32, 4 + 2 bands.
TINY_PE = TINY_PARITY + ["--i_embed", "0", "--i_embed_views", "0",
                         "--netdepth", "3", "--netwidth", "32",
                         "--netdepth_fine", "3", "--netwidth_fine", "32",
                         "--multires", "4", "--multires_views", "2"]
# The hash grid under the occupancy pass (a valid JAX pair).
TINY_HASH_OCC = TINY_PARITY + ["--use_occupancy", "--N_importance", "0",
                               "--occ_resolution", "16", "--occ_candidates",
                               "32", "--occ_samples", "8"]
PARITY_CONFIGS = {"hash_fine": TINY_PARITY, "pe_fine": TINY_PE,
                  "hash_occupancy": TINY_HASH_OCC}


def _close(got, want, tol, what=""):
    """Within ``tol`` of the largest |entry| of ``want``."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("use_viewdirs", [True, False])
def test_nerf_big_matches_jax(rng, use_viewdirs):
    """Init shapes and the forward (skip at layer 4, both heads) at 8 x 64
    with PE-sized inputs: 1e-5 (f32 summation order only)."""
    jp = j_init_nerf_big(jax.random.PRNGKey(0), D=8, W=64, input_ch=63,
                         input_ch_views=27, output_ch=5,
                         use_viewdirs=use_viewdirs)
    tree = {"params": {"coarse": jax.tree_util.tree_map(np.asarray, jp)}}
    model = bridge.params_from_numpy(tree)["params"]["coarse"]
    assert isinstance(model, NeRFBig) and model.use_viewdirs == use_viewdirs
    names = [n for n, _ in model.named_parameters()]
    assert "pts_linears.5.w" in names and "pts_linears.7.b" in names
    assert model.pts_linears[5].w.shape == (64 + 63, 64)  # after the skip
    pts = rng.standard_normal((300, 63)).astype(np.float32)
    views = rng.standard_normal((300, 27)).astype(np.float32)
    want = j_apply_nerf_big(jp, jnp.asarray(pts), jnp.asarray(views),
                            use_viewdirs=use_viewdirs)
    got = apply_nerf_big(model, T(pts), T(views) if use_viewdirs else None)
    assert got.shape == (300, 4 if use_viewdirs else 5)
    _close(got.detach(), want, 1e-5)
    assert bridge.params_to_numpy({"params": {"coarse": model}})["params"][
        "coarse"].keys() == tree["params"]["coarse"].keys()


@pytest.mark.parametrize("name", ["hash_fine", "pe_fine"])
def test_init_field_params_matches_jax_shapes(name):
    jcfg, tcfg, _ = configs(PARITY_CONFIGS[name])
    jp = j_init_field_params(jax.random.PRNGKey(0), jcfg.render.field)
    tp = init_field_params(torch.Generator().manual_seed(0), tcfg.render.field)
    want = jax.tree_util.tree_map(lambda a: a.shape, jp)
    got = jax.tree_util.tree_map(lambda a: a.shape, bridge.params_to_numpy(
        {"params": tp})["params"])
    assert got == want
    if "table" in tp:
        assert 0 < float(tp["table"].abs().max()) <= 1e-4


def _unit_dirs(rng, n):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", ["hash_fine", "pe_fine"])
def test_query_and_sigma_query_match_jax(rng, name):
    """An O(1) table (hash grid) so the features dominate; samples in and
    out of the box (sigma zeroed outside for the grid). 1e-5."""
    jcfg, tcfg, _ = configs(PARITY_CONFIGS[name])
    jstate, tstate = both_states(jcfg)
    if "table" in jstate["params"]:
        table = rng.standard_normal(jstate["params"]["table"].shape).astype(
            np.float32)
        jstate["params"]["table"] = jnp.asarray(table)
        tstate["params"]["table"] = T(table)
    pts = rng.uniform(-1.8, 1.8, size=(40, 8, 3)).astype(np.float32)
    vd = _unit_dirs(rng, 40)
    for mlp in ("coarse", "fine"):
        want, _ = j_query_field(jstate["params"], mlp, jnp.asarray(pts),
                                jnp.asarray(vd), jcfg.render.field, train=False)
        with torch.inference_mode():
            params = serving_params(tstate["params"], tcfg.render.field)
            got = query_field(params, mlp, T(pts), T(vd), tcfg.render.field)
        assert got.shape == (40, 8, 4)
        _close(got, want, 1e-5, mlp)
        want_s = j_sigma_query(jstate["params"], mlp, jnp.asarray(
            pts.reshape(-1, 3)), jcfg.render.field)
        with torch.inference_mode():
            got_s = sigma_query(params, mlp, T(pts.reshape(-1, 3)),
                                tcfg.render.field)
        _close(got_s, want_s, 1e-5, mlp)
    if name == "hash_fine":
        outside = np.any(np.abs(pts) > 1.5, axis=-1)
        assert outside.any() and np.all(got.numpy()[..., 3][outside] == 0.0)


def _rays(rng, n):
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32) + \
        np.array([0.0, 0.0, 4.0], np.float32)
    d = (rng.uniform(-0.3, 0.3, (n, 3)) + [0.0, 0.0, -1.0]).astype(np.float32)
    return o, d


def _opaque(rng, jstate, tstate):
    """Give the field real density in both states alike: an O(1) hash
    table, or a sigma bias of 2 in each NeRFBig's alpha head."""
    jp, tp = jstate["params"], tstate["params"]
    if "table" in jp:
        table = 3.0 * rng.standard_normal(jp["table"].shape).astype(np.float32)
        jp["table"] = jnp.asarray(table)
        tp["table"] = T(table)
        return
    for name in ("coarse", "fine"):
        jp[name] = {**jp[name], "alpha_linear": {
            **jp[name]["alpha_linear"],
            "b": jnp.full_like(jp[name]["alpha_linear"]["b"], 2.0)}}
        with torch.no_grad():
            tp[name].alpha_linear.b.fill_(2.0)


RENDER_KEYS = ("rgb_map", "depth_map", "acc_map", "disp_map", "sparsity_loss",
               "weights", "z_vals", "pts", "rgb0", "depth0", "acc0",
               "sparsity_loss0", "z_std")


@pytest.mark.parametrize("name", ["hash_fine", "pe_fine"])
@pytest.mark.parametrize("mode", ["test", "train"])
def test_hierarchical_render_rays_matches_jax(rng, name, mode):
    """Every output key of the hierarchical branch, in test mode and with
    the JAX draws replayed (stratified jitter, the fine pass's inverse-CDF
    draws, sigma noise in both passes): 1e-5 of each key's largest entry.
    ``_opaque`` gives the rays real weight.

    One tie is inherent to test mode: its last inverse-CDF draw is u = 1
    exactly, and the coarse cdf's last entry, an f32 sum of the normalized
    weights, ends a rounding step below or above 1 depending on the order
    of that sum (XLA's reduce_window against torch's cumsum). Below or at
    1, the sample sits on the last bin edge; above, inside the last bin by
    the rounding step over the last bin's weight. On such a ray that one
    fine sample differs, by less than one coarse bin, and the fine maps
    with it; those rays are held to that, every other ray to 1e-5."""
    jcfg, tcfg, _ = configs(PARITY_CONFIGS[name])
    jstate, tstate = both_states(jcfg)
    _opaque(rng, jstate, tstate)
    n = 64
    o, d = _rays(rng, n)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    near = np.full((n, 1), 2.0, np.float32)
    far = np.full((n, 1), 6.0, np.float32)
    jrc = jcfg.render if mode == "train" else jcfg.render.test_mode()
    trc = tcfg.render if mode == "train" else tcfg.render.test_mode()
    # The render's draws as a step with this key makes them: its first
    # split is the render's key.
    key = jax.random.PRNGKey(7)
    k_render = jax.random.split(key, 4)[0] if mode == "train" else None
    want, _ = j_render_rays(k_render, jstate["params"], jnp.asarray(o),
                            jnp.asarray(d), jnp.asarray(vd), jnp.asarray(near),
                            jnp.asarray(far), jrc, train=True)
    draws = None
    if mode == "train":
        draws = {k: v for k, v in jax_step_draws(key, jcfg, n, 0).items()
                 if k in ("t_rand", "u", "sigma_noise", "sigma_noise1")}
        assert len(draws) == 4
    with torch.no_grad():
        got = render_rays(tstate["params"], T(o), T(d), T(vd), T(near), T(far),
                          trc, draws=draws)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    z_diff = np.abs(got["z_vals"] - want["z_vals"]) > 1e-5 * 6.0
    tie = z_diff.any(axis=-1)
    if mode == "train":
        assert not tie.any()
    elif tie.any():
        bin_width = 4.0 / (jcfg.render.n_samples - 1)
        assert np.all(z_diff[tie].sum(axis=-1) == 1)
        assert np.abs(got["z_vals"] - want["z_vals"])[tie].max() < bin_width
        assert tie.mean() < 0.5
    for k in RENDER_KEYS:
        assert got[k].shape == want[k].shape, k
        fine_only = k not in ("rgb0", "depth0", "acc0", "sparsity_loss0")
        rows = ~tie if fine_only else slice(None)
        _close(got[k][rows], want[k][rows], 1e-5, k)
    assert float(want["acc_map"].max()) > 0.3


# RAdam (beta2 0.999) holds every parameter while its N_sma is under 5:
# the step of index 5 (t = 6) is the first that moves one.
FIRST_MOVE = 5


def _hold_first_move(got, want, before, lr):
    """One step from one state with RAdam's first move: every moment within
    1e-5 of its leaf's largest entry, the MLPs' parameters 1e-5 relative.
    A table entry moves by lr * rect * mu / sqrt(nu) (eps 1e-15), so its
    move carries the relative error of its first moment: where that moment
    is at least 1e-3 of the table's largest, the moments' 1e-5 bound it to
    1e-2 of the move, and there the move is held to that. Below it the
    entry's gradients lie at the rounding floor of their f32 sums (samples
    behind opaque ones, the 1e-10-sized sparsity and TV parts): the move
    of noise over noise is O(lr) of either sign, and the entry is held by
    its moments alone."""
    for m in ("mu", "nu"):
        assert_tree_close(got["opt"][m], want["opt"][m], 1e-5, m)
    mlps = [k for k in want["params"] if k != "table"]
    assert any(not np.array_equal(w, s) for k in mlps for w, s in zip(
        jax.tree_util.tree_leaves(want["params"][k]),
        jax.tree_util.tree_leaves(before[k])))
    for k in mlps:
        assert_tree_close(got["params"][k], want["params"][k], 1e-5, k)
    if "table" in want["params"]:
        moved = want["params"]["table"] - before["table"]
        mu = np.abs(want["opt"]["mu"]["table"])
        resolved = mu >= 1e-3 * mu.max()
        assert np.abs(moved).max() > 0.01 * lr and resolved.mean() > 0.3
        np.testing.assert_allclose(
            (got["params"]["table"] - before["table"])[resolved],
            moved[resolved], rtol=1e-2, atol=0, err_msg="table moves")


@pytest.mark.parametrize("name", sorted(PARITY_CONFIGS))
def test_parity_train_step_matches_jax(name):
    """Seven steps of both packages from one state with the JAX draws (the
    render's, the hash grid's TV cube origins, the grid refresh's) on the
    same rays: every step's loss, image loss and PSNR 1e-5 relative. The
    first step: every RAdam moment 1e-4 of its leaf's largest entry, the
    parameters after it the JAX ones bit for bit (RAdam moves none). RAdam's
    first move, one step from the JAX state both packages take it from, is
    held as ``_hold_first_move`` states; after seven steps the MLPs 1e-5
    relative. (The port's own state after seven steps is not held to the
    table: an entry moved by noise over noise at RAdam's first move, as
    ``_hold_first_move`` says, changes the next forward.)"""
    jcfg, tcfg, scene = configs(PARITY_CONFIGS[name])
    jstate, tstate = both_train_states(jcfg)
    sampler = jax_batch_sampler(scene, 64, seed=1)
    step_fn = jax_step_fn(jcfg)
    key = jax.random.PRNGKey(5)
    for step in range(7):
        key, sub = jax.random.split(key)
        b = sampler.next()
        batch = {k: b[k] for k in ("rays_o", "rays_d", "target")}
        if step == FIRST_MOVE:
            before = jax_train_state_numpy(jstate)
            shared, _ = train_step(bridge.state_from_numpy(before),
                                   {k: T(v) for k, v in batch.items()}, tcfg,
                                   draws=jax_step_draws(sub, jcfg, 64, step))
        jstate, jm = step_fn(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                             sub)
        tstate, tm = train_step(tstate, {k: T(v) for k, v in batch.items()},
                                tcfg, draws=jax_step_draws(sub, jcfg, 64, step))
        for k in ("loss", "img_loss", "psnr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"{k} at step {step}")
        want = jax_train_state_numpy(jstate)
        if step == 0:
            got = bridge.state_to_numpy(tstate)
            for m in ("mu", "nu"):
                assert_tree_close(got["opt"][m], want["opt"][m], 1e-4, m)
            assert_tree_close(got["params"], want["params"], 0, "params")
        if step == FIRST_MOVE:
            _hold_first_move(bridge.state_to_numpy(shared), want,
                             before["params"], float(jcfg.lrate))
    got = bridge.state_to_numpy(tstate)["params"]
    for k in ("coarse", "fine"):
        if k in want["params"]:
            assert_tree_close(got[k], want["params"][k], 1e-5, k)


def _parity_checkpoint(tmp_path, flags):
    """A JAX parity state with O(1) table entries (real opacity), written
    by the JAX package's save_checkpoint; (path, JAX state, configs)."""
    jcfg, tcfg, scene = configs(flags)
    jstate, _ = both_train_states(jcfg, seed=2)
    if "table" in jstate["params"]:
        rng = np.random.default_rng(0)
        table = 3.0 * rng.standard_normal(jstate["params"]["table"].shape)
        jstate["params"] = {**jstate["params"],
                            "table": jnp.asarray(table, jnp.float32)}
    path = jckpt.save_checkpoint(str(tmp_path / "jax"), 3, jstate)
    return path, jstate, (jcfg, tcfg, scene)


@pytest.mark.parametrize("name", ["hash_fine", "pe_fine"])
def test_jax_parity_checkpoint_imported_and_rendered(tmp_path, name):
    """Every leaf of a JAX parity checkpoint (the hash table, both nets,
    NeRFBig's pts_linears lists and heads) imports bit for bit, and the
    port's test-mode image from it is the JAX one: rgb, depth and acc
    within 1e-5 of their largest entry."""
    path, jstate, (jcfg, tcfg, scene) = _parity_checkpoint(tmp_path,
                                                          PARITY_CONFIGS[name])
    template = init_train_state(torch.Generator().manual_seed(9), tcfg)
    restored = ckpt.restore_checkpoint(path, template)
    got_tree = bridge.state_to_numpy(restored)
    want_tree = jax.tree_util.tree_map(np.asarray, {
        k: jstate[k] for k in ("params", "opt")})
    for (kp, w), g in zip(jax.tree_util.tree_flatten_with_path(want_tree)[0],
                          jax.tree_util.tree_leaves({k: got_tree[k] for k in
                                                     ("params", "opt")})):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(kp))
    # The port's own checkpoint of it names NeRFBig's leaves by path.
    own = torch.load(ckpt.save_checkpoint(str(tmp_path / "own"), 3, restored),
                     weights_only=True)
    if name == "pe_fine":
        assert "params.coarse.pts_linears.2.w" in own
        assert "opt.mu.fine.views_linears.0.b" in own
    H = W = 12
    focal = scene.hwf[2] * (W / scene.hwf[1])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    c2w = scene.poses[scene.i_test[0]][:3, :4]
    want = j_render_image(jstate["params"], H, W, K, c2w, scene.near,
                          scene.far, jcfg.render, tile_rays=64)
    got = render_image(restored["params"], H, W, K, c2w, scene.near, scene.far,
                       tcfg.render, tile_rays=64)
    for k in ("rgb_map", "depth_map", "acc_map"):
        _close(got[k], want[k], 1e-5, k)
    assert want["acc_map"].max() > 0.3


def test_bytes_per_ray_follows_the_config():
    """The tile sizing of the parity path grows with the samples of the
    largest pass, the levels and the net's width; the flagship's stays
    BYTES_PER_RAY."""
    _, hash_cfg, _ = configs(TINY_PARITY)
    _, pe_cfg, _ = configs(TINY_PE)
    rc = hash_cfg.render
    one = renderer.bytes_per_ray(rc)
    assert renderer.bytes_per_ray(dataclasses.replace(rc, n_importance=24)) \
        == 2 * one
    assert renderer.bytes_per_ray(pe_cfg.render) > 0
    _, flag_cfg, _ = configs(TINY_FLAGSHIP)
    assert renderer.bytes_per_ray(flag_cfg.render) == renderer.BYTES_PER_RAY
    # configs/lego.txt's fine pass: 192 samples x 16 levels, ~1 MB.
    _, lego, _ = configs(["--dataset_type", "synthetic", "--use_viewdirs",
                          "--N_samples", "64", "--N_importance", "128"])
    assert 0.3e6 < renderer.bytes_per_ray(lego.render) < 2e6
    assert renderer.default_tile_rays(torch.device("cpu"), lego.render) == \
        renderer.CPU_TILE_RAYS


def test_bake_of_a_hash_grid_field_matches_jax(rng):
    """bake_field of an i_embed 1 field (the vertex sweep through the hash
    encode): sigma and geo tables within one bf16 step of the JAX bake."""
    from indoor_nerf_tpu.render.baked import bake_field as j_bake_field
    from indoor_nerf_tpu_torch.render.baked import bake_field

    jcfg, tcfg, _ = configs(TINY_PARITY)
    jstate, tstate = both_states(jcfg)
    table = rng.standard_normal(jstate["params"]["table"].shape).astype(np.float32)
    jstate["params"]["table"] = jnp.asarray(table)
    tstate["params"]["table"] = T(table)
    want = j_bake_field(jstate["params"], jcfg.render.field, resolution=8,
                        geo_resolution=0)
    got = bake_field(tstate["params"], tcfg.render.field, resolution=8,
                     geo_resolution=0)
    assert got["config"].bbox_min == want["config"].bbox_min
    for k in ("sigma_table", "voxel_geo"):
        w = np.asarray(want[k], np.float32)
        g = got[k].float().numpy()
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7,
                                   atol=2.0 ** -7 * np.abs(w).max(), err_msg=k)
