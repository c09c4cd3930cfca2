"""The ``--reg_views`` depth-smoothness patches in the port against the JAX
package: the patch sampler (a numpy copy, equal bit for bit on the same
seeds), ``patch_depth_regularizer`` (values and gradients within 1e-6
relative: the same f32 ops), and the training step with patches (the
patch render's draws replayed from JAX's ``fold_in(key, 17)``) on the
flagship, NDC, the hash grid, the grouped encode and A-CAQ, held as the
step parity tests hold theirs (``hold_step``; quantized steps, and the
NDC step for the reason its test gives, in norm as
``test_torch_acaq_step.py``) and the patches' ``reg_depth_tv`` within 1e-5
relative (the patch render's sums in another f32 order). A step whose
patches are off is the step without them, bit for bit."""

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
    configs,
    hold_step,
    one_step,
)
from indoor_nerf_tpu.data.pipeline import UnobservedPatchSampler as JSampler
from indoor_nerf_tpu.ops.tv import patch_depth_regularizer as j_patch_reg
from indoor_nerf_tpu_torch.data.pipeline import UnobservedPatchSampler
from indoor_nerf_tpu_torch.data.scene_files import make_plane_scene, write_llff_scene
from indoor_nerf_tpu_torch.data.synthetic import make_synthetic_scene
from indoor_nerf_tpu_torch.ops.tv import patch_depth_regularizer
from indoor_nerf_tpu_torch.train import trainer
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.train.optim import named_leaves
from indoor_nerf_tpu_torch.train.step import draw_step, train_step
from test_torch_acaq_step import hold_quant, hold_quantized_step

torch.set_num_threads(1)
REG = ["--reg_views", "2"]
N_PATCHES, PATCH = 2, 8


@pytest.fixture(autouse=True)
def f32_scatter(monkeypatch):
    """The JAX fused backward through its f32-accumulating Pallas kernel."""
    monkeypatch.setattr(jbh, "_FORCE_PALLAS_SCATTER_INTERPRET", True)


def patches(seed=13, pose_mode="novel"):
    """``one_step``'s ``extra``: the first batch of the port's patch sampler
    over the scene's training cameras."""
    def extra(scene):
        H, W, _ = scene.hwf
        return UnobservedPatchSampler(
            scene.poses[scene.i_train], int(H), int(W), scene.K,
            n_patches=N_PATCHES, patch=PATCH, seed=seed,
            pose_mode=pose_mode).next()
    return extra


@pytest.mark.parametrize("pose_mode", ["novel", "train"])
@pytest.mark.parametrize("seed", [0, 5])
def test_patch_sampler_matches_jax(pose_mode, seed):
    scene = make_synthetic_scene(n_views=8, H=32, W=32)
    H, W, _ = scene["hwf"]
    poses = scene["poses"][scene["i_split"][0]]
    kw = dict(n_patches=3, patch=8, seed=seed, pose_mode=pose_mode)
    got = UnobservedPatchSampler(poses, H, W, scene["K"], **kw)
    want = JSampler(poses, H, W, scene["K"], **kw)
    for attr in ("center", "up", "sigma", "pos"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
    for _ in range(3):
        g, w = got.next(), want.next()
        assert g.keys() == w.keys() == {"reg_rays_o", "reg_rays_d"}
        for k in w:
            assert g[k].dtype == np.float32 and g[k].shape == (3 * 64, 3)
            np.testing.assert_array_equal(g[k], w[k])


def test_patch_sampler_single_camera_and_size_guard():
    scene = make_synthetic_scene(n_views=4, H=16, W=16)
    H, W, _ = scene["hwf"]
    one = scene["poses"][scene["i_split"][0]][:1]
    got = UnobservedPatchSampler(one, H, W, scene["K"], n_patches=2, patch=8)
    want = JSampler(one, H, W, scene["K"], n_patches=2, patch=8)
    g, w = got.next(), want.next()
    assert np.all(np.isfinite(g["reg_rays_d"]))
    for k in w:
        np.testing.assert_array_equal(g[k], w[k])
    for sampler in (UnobservedPatchSampler, JSampler):
        with pytest.raises(ValueError, match="exceeds image"):
            sampler(one, H, W, scene["K"], n_patches=1, patch=32)
        with pytest.raises(ValueError, match="pose_mode"):
            sampler(one, H, W, scene["K"], n_patches=1, pose_mode="typo")


@pytest.mark.parametrize("mode", ["tv", "planar"])
def test_patch_depth_regularizer_matches_jax(mode):
    """Values and the gradients w.r.t. depth and acc, 1e-6 relative (of
    the largest gradient entry for the gradients)."""
    rng = np.random.default_rng(3)
    depth = rng.uniform(2.0, 6.0, 3 * 64).astype(np.float32)
    depth[:5] = 1e-8  # empty rays: the planar disparity's clamp
    acc = rng.uniform(0.0, 1.0, 3 * 64).astype(np.float32)

    def j_fn(d, a):
        return j_patch_reg(d, a, 8, 2.0, 6.0, mode=mode)

    want = float(j_fn(depth, acc))
    jd, ja = jax.grad(j_fn, argnums=(0, 1))(jnp.asarray(depth), jnp.asarray(acc))
    d, a = (torch.from_numpy(x).requires_grad_(True) for x in (depth, acc))
    got = patch_depth_regularizer(d, a, 8, 2.0, 6.0, mode=mode)
    gd, ga = torch.autograd.grad(got, [d, a], allow_unused=True)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    np.testing.assert_allclose(gd.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6 * float(np.abs(jd).max()))
    if mode == "planar":
        np.testing.assert_allclose(ga.numpy(), np.asarray(ja), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(ja).max()))
    else:  # tv reads no acc: JAX's gradient is zero, torch's None
        assert ga is None and not np.asarray(ja).any()


def test_planar_mode_is_zero_on_slanted_planes():
    """A plane's disparity is affine in the pixel: 'planar' costs zero at
    any slant, 'tv' charges the slope, a floater pays in both modes, and
    empty rays (acc 0) cost nothing in 'planar'."""
    ps, near, far = 8, 2.0, 6.0
    u, v = np.meshgrid(np.arange(ps), np.arange(ps), indexing="xy")
    disp = 0.5 + 0.03 * u + 0.02 * v
    depth = torch.tensor(((far - near) / disp).reshape(-1), dtype=torch.float32)
    acc = torch.ones_like(depth)
    planar = float(patch_depth_regularizer(depth, acc, ps, near, far, "planar"))
    tv = float(patch_depth_regularizer(depth, acc, ps, near, far, "tv"))
    assert planar < 1e-9 and tv > 1e-4
    spiked = depth.clone().reshape(ps, ps)
    spiked[4, 4] *= 0.3
    spiked = spiked.reshape(-1)
    assert float(patch_depth_regularizer(spiked, acc, ps, near, far,
                                         "planar")) > 1e-3
    assert float(patch_depth_regularizer(spiked, acc, ps, near, far,
                                         "tv")) > tv
    empty = patch_depth_regularizer(torch.full((ps * ps,), 1e-8),
                                    torch.zeros(ps * ps), ps, near, far,
                                    "planar")
    assert float(empty) == 0.0


@pytest.fixture(scope="module")
def llff_flags(tmp_path_factory):
    """The flagship preset at test size on a 16-view LLFF plane (24x32
    views, NDC on), as tests/test_torch_ndc.py trains it."""
    root = str(tmp_path_factory.mktemp("llff"))
    write_llff_scene(root, make_plane_scene(16), 192, 256, 240.0, 8)
    return ["--flagship", "--dataset_type", "llff", "--datadir", root,
            "--use_viewdirs", "--n_levels", "4", "--finest_res", "32",
            "--log2_hashmap_size", "12", "--occ_resolution", "16",
            "--occ_candidates", "32", "--occ_samples", "8",
            "--raw_noise_std", "1"]


def hold_reg(jm, tm):
    """The patches' ungated ``reg_depth_tv``: 1e-5 relative."""
    assert float(jm["reg_depth_tv"]) > 0.0
    np.testing.assert_allclose(float(tm["reg_depth_tv"]),
                               float(jm["reg_depth_tv"]), rtol=1e-5)


# name: (flags, block table?)
STEPS = {
    "flagship_tv": (TINY_FLAGSHIP + REG, True),
    "flagship_planar": (TINY_FLAGSHIP + REG + ["--reg_mode", "planar"], True),
    "hash_grid": (TINY_HASH + REG, False),
    # The patch render takes the grouped encode too, as JAX's does.
    "grouped": (TINY_FLAGSHIP + REG + ["--ray_groups", "2,2,1,1"], True),
}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_patch_step_matches_jax(name):
    flags, block = STEPS[name]
    jm, tm, _, want, got, draws = one_step(flags, extra=patches())
    assert set(draws["reg"]) == set(draws) & {"t_rand", "u", "sigma_noise",
                                              "sigma_noise1"}
    hold_step(jm, tm, want, got, block_table=block)
    hold_reg(jm, tm)
    # The term is in the loss: the step without the patches differs.
    plain = one_step(flags)[1]
    np.testing.assert_allclose(
        float(tm["loss"]), float(plain["loss"]) + 0.1 * float(tm["reg_depth_tv"]),
        rtol=1e-6)


def test_patch_step_with_ndc_matches_jax(llff_flags):
    """LLFF: the patch rays projected into NDC, their viewdirs from the
    world rays, and the patch render's sigma noise. The moments are held in
    norm (``hold_quantized_step``: 1e-3 of each leaf's norm, the table's
    also by entry): in NDC the depths of neighbouring patch pixels differ
    by ~1e-3 of the [0, 1] range, so the smoothness gradient, a multiple
    of those differences, carries the f32 error of the depths (~5e-7,
    both renders agree to it) at ~5e-4 relative, and a few MLP moment
    entries (1% of the first sigma layer's) then differ by 6e-4 of the
    leaf's largest entry."""
    jm, tm, _, want, got, draws = one_step(llff_flags + REG, extra=patches())
    assert "sigma_noise" in draws["reg"]
    hold_quantized_step(jm, tm, want, got, block_table=True)
    hold_reg(jm, tm)


@pytest.mark.parametrize("step", [3, 600])
def test_patch_step_with_acaq_matches_jax(step):
    """A quantized step with patches (before and after the grid
    quantizer's warmup): the patch render's calibration is dropped, so
    the quantizer state after the step is JAX's."""
    from indoor_nerf_tpu_torch.train import step as tstep

    flags = TINY_FLAGSHIP + REG + ["--use_quantization"]
    jm, tm, _, want, got, _ = one_step(flags, step=step, extra=patches())
    hold_quantized_step(jm, tm, want, got, block_table=True)
    hold_quant(want, got)
    hold_reg(jm, tm)
    assert tstep.reg_active(configs(flags)[1], N_PATCHES * PATCH ** 2)


def test_reg_start_iter_gates_the_loss():
    """Before ``reg_start_iter`` the loss and the update are those of the
    step without the patches, bit for bit (the term is multiplied by 0),
    and JAX's; from it on the term is added."""
    flags = TINY_FLAGSHIP + REG + ["--reg_start_iter", "3"]
    jm, tm, _, want, got, draws = one_step(flags, step=2, extra=patches())
    hold_step(jm, tm, want, got, block_table=True)
    hold_reg(jm, tm)
    _, base, _, _, got0, draws0 = one_step(flags, step=2)
    assert "reg" not in draws0
    assert float(tm["loss"]) == float(base["loss"])
    for key in ("params", "opt"):
        for (path, w), g in zip(
                jax.tree_util.tree_flatten_with_path(got0[key])[0],
                jax.tree_util.tree_leaves(got[key])):
            np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    jm3, tm3, _, want3, got3, _ = one_step(flags, step=3, extra=patches())
    hold_step(jm3, tm3, want3, got3, block_table=True)
    _, base3, _, _, _, _ = one_step(flags, step=3)
    np.testing.assert_allclose(
        float(tm3["loss"]), float(base3["loss"]) + 0.1 * float(tm3["reg_depth_tv"]),
        rtol=1e-6)


def test_reg_views_zero_is_the_step_without_patches():
    """``--reg_views 0``: no patch render and no patch draws, whatever the
    batch carries, so the step is today's step bit for bit; with patches,
    every draw but ``draws["reg"]`` is the one the step without them makes
    (the patch draws come last)."""
    _, off, _ = configs(TINY_FLAGSHIP)
    _, on, scene = configs(TINY_FLAGSHIP + REG)
    assert off.reg_depth_tv_weight == 0.0 and on.reg_depth_tv_weight == 0.1
    n_reg = N_PATCHES * PATCH ** 2
    for step in (0, 1):
        plain = draw_step(torch.Generator().manual_seed(4), off, step, 64)
        same = draw_step(torch.Generator().manual_seed(4), off, step, 64,
                         n_reg_rays=n_reg)
        with_reg = draw_step(torch.Generator().manual_seed(4), on, step, 64,
                             n_reg_rays=n_reg)
        assert set(plain) == set(same) == set(with_reg) - {"reg"}
        for k in plain:
            assert torch.equal(plain[k], same[k]) and torch.equal(
                plain[k], with_reg[k]), k
    batch = {k: torch.from_numpy(v)
             for k, v in _batches(TINY_FLAGSHIP + REG, scene, on)[0].items()}
    runs = []
    for b in (batch, {k: v for k, v in batch.items()
                      if not k.startswith("reg_")}):
        state = trainer.init_train_state(torch.Generator().manual_seed(0), off)
        for _ in range(7):  # RAdam moves the params from step 6 on
            state, m = train_step(state, b, off, torch.Generator().manual_seed(1))
        runs.append((named_leaves(state["params"]), m))
    (p1, m1), (p2, m2) = runs
    assert "reg_depth_tv" not in m1 and float(m1["loss"]) == float(m2["loss"])
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k


def _batches(flags, scene, cfg, n=1):
    """make_sampler's first ``n`` batches of 64 rays for the CLI ``flags``."""
    sample, _ = trainer.make_sampler(parse_args(flags + ["--N_rand", "64"]),
                                     scene, cfg, 0)
    return [sample(i) for i in range(1, n + 1)]


def test_sampler_carries_only_what_the_step_reads():
    """The batches hold ``img_idx`` only for a field with latents and the
    patch rays only while their weight is positive; the patch sampler
    draws with ``--reg_views`` whatever the weight (as JAX's), so the rays
    of later steps do not move."""
    base = {"rays_o", "rays_d", "target"}
    _, on, scene = configs(TINY_FLAGSHIP + REG)
    weighed = _batches(TINY_FLAGSHIP + REG, scene, on, 2)
    assert set(weighed[0]) == base | {"reg_rays_o", "reg_rays_d"}
    zero_flags = TINY_FLAGSHIP + REG + ["--reg_depth_tv_weight", "0"]
    zero = _batches(zero_flags, scene, configs(zero_flags)[1], 2)
    assert set(zero[0]) == base
    for a, b in zip(weighed, zero):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    app_flags = TINY_FLAGSHIP + ["--use_appearance"]
    (app,) = _batches(app_flags, scene, configs(app_flags)[1])
    assert set(app) == base | {"img_idx"}


def test_trainer_prints_the_reg_line_and_resumes_the_patches(tmp_path, capsys):
    """A run with patches prints JAX's ``[reg]`` line, and a resumed run
    replays the patch sampler and the patch draws: its losses and leaves
    equal the uninterrupted run's bit for bit."""
    flags = TINY_FLAGSHIP + CPU + REG + [
        "--reg_mode", "planar", "--N_rand", "32", "--i_print", "100",
        "--basedir", str(tmp_path)]

    def run(name, n):
        return trainer.train(parse_args(flags + ["--expname", name,
                                                 "--n_iters", str(n)]))

    whole = run("whole", 6)
    assert ("[reg] unobserved-view depth TV: 2 patch(es)/step of 8^2 rays, "
            "weight 0.1") in capsys.readouterr().out
    run("cut", 2)
    rest = run("cut", 6)
    assert rest["losses"] == whole["losses"][2:]
    got, want = (named_leaves(r["state"]["params"]) for r in (rest, whole))
    for k in want:
        assert torch.equal(got[k], want[k]), k
