"""The ``--use_appearance`` latents and the NeRF-W half-image fit
(``--render_fit_appearance``) in the port against the JAX package.

- The appearance table and the view bias: a zero latent renders the field
  without one bit for bit; an appearance step (the batch's latent rows
  added after the view anneal) is held as the step parity tests hold
  theirs (``hold_step``), the appearance leaf's update within 1e-5 of its
  largest entry, and the rows the batch did not sample decay in RAdam's
  moments exactly as JAX's (the gather's gradient is dense); with A-CAQ
  the controller's quantizer-free forward passes the same bias (held as
  ``test_torch_acaq_step.py``).
- ``fit_view_latent`` against JAX's at 10 Adam steps and 256 rays: the
  latent within 1e-4 of its norm (each step's gradient is a sum over the
  rays and samples in another f32 order, and Adam normalises it), the
  final left-half MSE within 1e-5 relative; no field tensor gets a
  gradient.
- The numpy copies (``_left_half_rays``, ``right_half_psnr``,
  ``fit_affine_color``, ``eval_view_with_fitted_affine``) equal the JAX
  functions bit for bit on the same seeds.
- Checkpoints with the leaf (the port's round trip, a JAX checkpoint's
  import) and the CLI on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indoor_nerf_tpu.ops.blockhash as jbh
from _torch_parity import (
    CPU,
    TINY_FLAGSHIP,
    TINY_HASH,
    assert_tree_close,
    configs,
    hold_step,
    jax_batch_sampler,
    jax_step_fn,
    jax_train_state_numpy,
    one_step,
)
from indoor_nerf_tpu.render import appearance as jap
from indoor_nerf_tpu.render.renderer import make_image_renderer as j_image_renderer
from indoor_nerf_tpu.train.step import init_train_state as j_init
from indoor_nerf_tpu.utils import checkpoint as jckpt
from indoor_nerf_tpu_torch import bridge
from indoor_nerf_tpu_torch.models.field import init_field_params
from indoor_nerf_tpu_torch.render import appearance as tap
from indoor_nerf_tpu_torch.render.renderer import (
    make_image_renderer,
    render_rays,
)
from indoor_nerf_tpu_torch.train import trainer
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.train.optim import named_leaves
from indoor_nerf_tpu_torch.train.step import init_train_state
from indoor_nerf_tpu_torch.utils import checkpoint as ckpt
from test_torch_acaq_step import ACAQ, _calibrated, hold_quant, hold_quantized_step

torch.set_num_threads(1)
APP = ["--use_appearance"]


@pytest.fixture(autouse=True)
def f32_scatter(monkeypatch):
    """The JAX fused backward through its f32-accumulating Pallas kernel."""
    monkeypatch.setattr(jbh, "_FORCE_PALLAS_SCATTER_INTERPRET", True)


def test_appearance_table_is_jax_s():
    """One zero ``[n_images, input_ch_views]`` row per image of the scene
    with ``--use_appearance --use_viewdirs``, none without viewdirs."""
    jcfg, tcfg, scene = configs(TINY_FLAGSHIP + APP)
    jf, tf = jcfg.render.field, tcfg.render.field
    assert tf.n_appearance == jf.n_appearance == len(scene.images) > 0
    params = init_field_params(torch.Generator().manual_seed(0), tf)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)["params"]
    assert params["appearance"].shape == jparams["appearance"].shape == (
        len(scene.images), tf.input_ch_views)
    assert not params["appearance"].any()
    flags = [f for f in TINY_FLAGSHIP if f != "--use_viewdirs"] + APP
    jcfg, tcfg, _ = configs(flags)
    assert tcfg.render.field.n_appearance == jcfg.render.field.n_appearance == 0


def test_zero_view_bias_is_no_bias():
    _, tcfg, scene = configs(TINY_FLAGSHIP + APP)
    state = init_train_state(torch.Generator().manual_seed(0), tcfg)
    n = 50
    rng = np.random.default_rng(0)
    ro = torch.from_numpy(np.tile(scene.poses[0][:3, 3], (n, 1)).astype(np.float32))
    rd = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    near, far = torch.full((n, 1), scene.near), torch.full((n, 1), scene.far)
    cfg = tcfg.render.test_mode()
    with torch.no_grad():
        outs = [render_rays(state["params"], ro, rd, vd, near, far, cfg,
                            occ_state=state["occ"], train=False,
                            view_bias=vb)[0]
                for vb in (None, torch.zeros(n, tcfg.render.field.input_ch_views))]
    for k in ("rgb_map", "depth_map", "acc_map"):
        assert torch.equal(outs[0][k], outs[1][k]), k


def image_ids(scene):
    """``one_step``'s ``extra``: the image of each ray of its batch (the
    same sampler and seed as ``step_batch``'s)."""
    return {"img_idx": jax_batch_sampler(scene, 64, seed=1).next()["img_idx"]}


def trained_rows(jstate):
    """A state edit: random latents and moments on every row and RAdam
    past its rectification threshold, so that a step moves every row."""
    rng = np.random.default_rng(11)
    shape = jstate["params"]["appearance"].shape

    def rand(scale):
        return jnp.asarray(scale * rng.standard_normal(shape), jnp.float32)

    opt = dict(jstate["opt"], step=jnp.asarray(10, jnp.int32))
    opt["mu"] = dict(opt["mu"], appearance=rand(1e-3))
    opt["nu"] = dict(opt["nu"], appearance=jnp.abs(rand(1e-6)))
    return {**jstate, "opt": opt,
            "params": dict(jstate["params"], appearance=rand(0.3))}


# name: (flags, step, block table?)
STEPS = {
    "flagship": (TINY_FLAGSHIP + APP, 0, True),
    # The latent goes after the view anneal: added before it, it would be
    # scaled by the ramp (0.4 at step 4 of 10).
    "view_anneal": (TINY_FLAGSHIP + APP + ["--view_anneal_iters", "10"], 4,
                    True),
    "hash_grid": (TINY_HASH + APP, 0, False),
}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_appearance_step_matches_jax(name):
    flags, step, block = STEPS[name]
    jm, tm, before, want, got, _ = one_step(flags, step=step,
                                            edit=trained_rows, extra=image_ids)
    hold_step(jm, tm, want, got, block_table=block)
    w, g = want["params"]["appearance"], got["params"]["appearance"]
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * float(np.abs(w).max()))
    assert (w != before["params"]["appearance"]).all(axis=1).all()
    # The rows no ray of the batch reads: a zero gradient, the moments'
    # decay and the weight decay, equal to JAX's bit for bit.
    scene = configs(flags)[2]
    unread = np.setdiff1d(np.arange(len(scene.images)),
                          image_ids(scene)["img_idx"])
    assert len(unread) > 0
    for key in ("mu", "nu"):
        np.testing.assert_array_equal(got["opt"][key]["appearance"][unread],
                                      want["opt"][key]["appearance"][unread])
    np.testing.assert_array_equal(g[unread], w[unread])
    # The latents act: the step without img_idx (no bias) differs. It
    # gives the table no gradient, and RAdam moves every row as JAX's zero
    # gradient does.
    jm0, tm0, _, want0, got0, _ = one_step(flags, step=step, edit=trained_rows)
    assert float(tm0["loss"]) != float(tm["loss"])
    hold_step(jm0, tm0, want0, got0, block_table=block)
    for key in ("mu", "nu"):
        np.testing.assert_array_equal(got0["opt"][key]["appearance"],
                                      want0["opt"][key]["appearance"])
    np.testing.assert_array_equal(got0["params"]["appearance"],
                                  want0["params"]["appearance"])


def test_appearance_controller_step_matches_jax():
    """A-CAQ at a controller step in MDL mode: the quantizer-free forward
    passes the batch's latents too (JAX :433-438), so the inflation EMA
    and the bits are JAX's."""
    def edit(jstate):
        return trained_rows(_calibrated(jstate))

    jm, tm, before, want, got, _ = one_step(TINY_FLAGSHIP + APP + ACAQ,
                                            step=600, edit=edit,
                                            extra=image_ids)
    hold_quantized_step(jm, tm, want, got, block_table=True)
    hold_quant(want, got)
    assert float(got["infl_ema"]) != float(before["infl_ema"])


@pytest.fixture(scope="module")
def field():
    """A flagship field at test size whose table is O(1) from a seed, so
    that its rays are opaque and the view branch shapes the colour: the
    JAX state, the port's, and the port's config and scene."""
    jcfg, tcfg, scene = configs(TINY_FLAGSHIP + APP)
    jstate = j_init(jax.random.PRNGKey(0), jcfg)
    table = np.random.default_rng(7).standard_normal(
        jstate["params"]["table"].shape).astype(np.float32)
    jstate = {**jstate, "params": {**jstate["params"],
                                   "table": jnp.asarray(table)}}
    tstate = bridge.state_from_numpy(jax_train_state_numpy(jstate))
    return jstate, tstate, jcfg, tcfg, scene


def _view(scene, i=None):
    i = int(scene.i_test[0]) if i is None else i
    return np.asarray(scene.poses[i]), np.asarray(scene.images[i])


def test_fit_view_latent_matches_jax(field):
    jstate, tstate, jcfg, tcfg, scene = field
    c2w, gt = _view(scene)
    kw = dict(n_steps=10, n_rays=256, lrate=0.05, seed=3)
    jz, jmse = jap.fit_view_latent(jstate["params"], c2w, scene.K, scene.near,
                                   scene.far, gt, jcfg.render,
                                   occ_state=jstate["occ"], **kw)
    before = {k: v.clone() for k, v in named_leaves(tstate["params"]).items()}
    tz, tmse = tap.fit_view_latent(tstate["params"], c2w, scene.K, scene.near,
                                   scene.far, gt, tcfg.render,
                                   occ_state=tstate["occ"], **kw)
    jz = np.asarray(jz)
    assert np.linalg.norm(jz) > 0.1  # ten steps of lrate 0.05 moved it
    assert np.linalg.norm(tz.numpy() - jz) <= 1e-4 * np.linalg.norm(jz)
    np.testing.assert_allclose(tmse, jmse, rtol=1e-5)
    # No gradient reached the field, and the fit changed none of it.
    for k, t in named_leaves(tstate["params"]).items():
        assert t.grad is None and torch.equal(t, before[k]), k
    _, zero_mse = tap.fit_view_latent(tstate["params"], c2w, scene.K,
                                      scene.near, scene.far, gt, tcfg.render,
                                      occ_state=tstate["occ"],
                                      **{**kw, "n_steps": 0})
    assert tmse < zero_mse


def test_eval_view_with_fitted_latent_matches_jax(field):
    """The half-image protocol's dict: JAX's keys, the right-half PSNRs
    within 1e-3 dB, the fit's MSE within 1e-5 relative."""
    jstate, tstate, jcfg, tcfg, scene = field
    c2w, gt = _view(scene)
    H, W = gt.shape[:2]
    kw = dict(n_steps=10, n_rays=256, seed=1)
    want = jap.eval_view_with_fitted_latent(
        j_image_renderer(jcfg.render.test_mode(), H, W, 512), jstate["params"],
        c2w, scene.K, scene.near, scene.far, gt, jcfg.render,
        occ_state=jstate["occ"], **kw)
    got = tap.eval_view_with_fitted_latent(
        make_image_renderer(tcfg.render.test_mode(), H, W, 512),
        tstate["params"], c2w, scene.K, scene.near, scene.far, gt,
        tcfg.render, occ_state=tstate["occ"], **kw)
    assert got.keys() == want.keys()
    for k in ("psnr_right_zero", "psnr_right_fitted"):
        assert abs(got[k] - want[k]) <= 1e-3, k
    np.testing.assert_allclose(got["fit_mse_left"], want["fit_mse_left"],
                               rtol=1e-5)
    assert got["psnr_right_fitted"] != got["psnr_right_zero"]


def test_fit_needs_viewdirs(field):
    import dataclasses

    _, tstate, _, tcfg, scene = field
    rc = dataclasses.replace(tcfg.render, field=dataclasses.replace(
        tcfg.render.field, use_viewdirs=False))
    c2w, gt = _view(scene)
    with pytest.raises(ValueError, match="use_viewdirs"):
        tap.fit_view_latent(tstate["params"], c2w, scene.K, scene.near,
                            scene.far, gt, rc)


@pytest.mark.parametrize("seed,n_rays", [(0, 100), (4, 10_000)])
def test_left_half_rays_copy_is_identical(seed, n_rays):
    rng = np.random.default_rng(seed)
    gt = rng.random((12, 17, 3)).astype(np.float32)
    _, _, scene = configs(TINY_FLAGSHIP)
    c2w = scene.poses[1][:3, :4]
    for g, w in zip(tap._left_half_rays(gt, c2w, scene.K, n_rays, seed),
                    jap._left_half_rays(gt, c2w, scene.K, n_rays, seed)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_half_image_scores_and_affine_fit_copies_are_identical(seed):
    rng = np.random.default_rng(seed)
    gt = rng.random((10, 14, 3)).astype(np.float32)
    pred = np.clip(0.8 * gt + 0.05 + 0.02 * rng.standard_normal(gt.shape),
                   0, 1).astype(np.float32)
    assert tap.right_half_psnr(pred, gt) == jap.right_half_psnr(pred, gt)
    for g, w in zip(tap.fit_affine_color(pred, gt),
                    jap.fit_affine_color(pred, gt)):
        np.testing.assert_array_equal(g, w)
    const = np.full_like(pred, 0.5)  # var 0: the identity gain
    for g, w in zip(tap.fit_affine_color(const, gt),
                    jap.fit_affine_color(const, gt)):
        np.testing.assert_array_equal(g, w)
    assert tap.eval_view_with_fitted_affine(pred, gt) == \
        jap.eval_view_with_fitted_affine(pred, gt)


SMALL = TINY_FLAGSHIP + CPU + APP + ["--N_rand", "64", "--i_print", "100",
                                     "--lrate", "0.01"]


def test_checkpoint_round_trip_with_the_leaf(tmp_path):
    """The appearance leaf and its moments are saved and restored bit for
    bit; a state built without ``--use_appearance`` refuses the file."""
    out = trainer.train(parse_args(SMALL + ["--n_iters", "7", "--expname",
                                            "app", "--basedir", str(tmp_path)]))
    state = out["state"]
    assert state["params"]["appearance"].abs().max() > 0  # RAdam moved it
    path = ckpt.list_checkpoints(out["logdir"])[-1]
    cfg = configs(TINY_FLAGSHIP + APP)[1]
    restored = ckpt.restore_checkpoint(path, init_train_state(
        torch.Generator().manual_seed(3), cfg))
    saved, back = (ckpt._tensor_leaves(s) for s in (state, restored))
    assert "params.appearance" in saved and "opt.nu.appearance" in saved
    assert saved.keys() == back.keys()
    for k in saved:
        assert torch.equal(saved[k], back[k]), k
    with pytest.raises(ValueError, match="--use_appearance"):
        ckpt.restore_checkpoint(path, init_train_state(
            torch.Generator().manual_seed(3), configs(TINY_FLAGSHIP)[1]))


def test_jax_checkpoint_with_the_leaf_imports_and_renders(tmp_path):
    """A JAX checkpoint trained with ``--use_appearance`` (7 JAX steps: the
    latents move) imports leaf for leaf and renders what JAX renders with
    its zero latent (1e-3, as tests/test_torch_checkpoint.py)."""
    from indoor_nerf_tpu.render.renderer import render_image as j_render_image
    from indoor_nerf_tpu_torch.render.renderer import render_image

    jcfg, tcfg, scene = configs(TINY_FLAGSHIP + APP)
    jstate = j_init(jax.random.PRNGKey(0), jcfg)
    sampler, step_fn = jax_batch_sampler(scene, 64), jax_step_fn(jcfg)
    key = jax.random.PRNGKey(1)
    for _ in range(7):
        key, sub = jax.random.split(key)
        jstate, _ = step_fn(jstate, {k: jnp.asarray(v) for k, v in
                                     sampler.next().items()}, sub)
    assert np.abs(np.asarray(jstate["params"]["appearance"])).max() > 0
    path = jckpt.save_checkpoint(str(tmp_path / "jax"), 7, jstate)
    restored = ckpt.restore_checkpoint(path, init_train_state(
        torch.Generator().manual_seed(3), tcfg))
    got = bridge.state_to_numpy(restored)
    want = jax_train_state_numpy(jstate)
    for key_ in ("params", "opt"):
        assert_tree_close(got[key_], want[key_], 0, key_)
    H = W = 16
    focal = scene.hwf[2] * (W / scene.hwf[1])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    c2w = scene.poses[scene.i_test[0]][:3, :4]
    jimg = j_render_image(jstate["params"], H, W, K, c2w, scene.near,
                          scene.far, jcfg.render, tile_rays=256,
                          occ_state=jstate["occ"])
    timg = render_image(restored["params"], H, W, K, c2w, scene.near,
                        scene.far, tcfg.render, tile_rays=256,
                        occ_state=restored["occ"])
    np.testing.assert_allclose(timg["rgb_map"], jimg["rgb_map"], rtol=0,
                               atol=1e-3)


def test_render_fit_appearance_writes_jax_s_file(tmp_path, capsys):
    """``--render_only --render_test --render_fit_appearance`` after a
    short ``--use_appearance`` run: a ``[fit-appearance]`` line per
    held-out view and the mean, and ``fit_appearance.json`` with the JAX
    trainer's keys (trainer.py:340-351), before the usual render-only
    test set. Views of 16x16: the fit's 100 Adam steps then render 128
    rays each."""
    flags = SMALL + ["--synthetic_res", "16", "--expname", "fit",
                     "--basedir", str(tmp_path)]
    trainer.train(parse_args(flags + ["--n_iters", "6"]))
    capsys.readouterr()
    out = trainer.train(parse_args(flags + [
        "--n_iters", "6", "--render_only", "--render_test",
        "--render_fit_appearance"]))
    text = capsys.readouterr().out
    n_test = len(configs(TINY_FLAGSHIP)[2].i_test)
    assert text.count("[fit-appearance] view ") == n_test
    assert "[fit-appearance] mean right-half PSNR: zero" in text
    with open(os.path.join(out["savedir"], "fit_appearance.json")) as f:
        saved = json.load(f)
    assert set(saved) == {"views", "mean_zero", "mean_fitted"}
    assert len(saved["views"]) == n_test
    for row in saved["views"]:
        assert set(row) == {"psnr_right_zero", "psnr_right_fitted",
                            "fit_mse_left"}
    assert saved == out["fit_appearance"]
    assert out["step"] == 6 and len(out["psnrs"]) == n_test
