"""Port parity: the flagship training step against the JAX package.

The same numpy-seeded inputs, the same bridged state and the JAX random
draws replayed into the port's ``draws=`` go through both. The JAX encode
backward runs its Pallas scatter in interpret mode
(``_FORCE_PALLAS_SCATTER_INTERPRET``): that is the f32-accumulating path
the TPU runs, and the port's numerics; the JAX CPU default accumulates in
bf16 instead.
"""

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
    assert_tree_close,
    both_states,
    both_train_states,
    check_train_step_matches_jax,
    configs,
    jax_batch_sampler,
    jax_step_draws,
    jax_step_fn,
    jax_train_state_numpy,
)
from indoor_nerf_tpu.data.pipeline import BatchedRaySampler as JBatchedRaySampler
from indoor_nerf_tpu.models.field import sigma_query as j_sigma_query
from indoor_nerf_tpu.ops.occupancy import occupancy_update as j_occupancy_update
from indoor_nerf_tpu.train.optim import (
    exp_decay_lr as j_exp_decay_lr,
    init_radam_state as j_init_radam_state,
    pocketnerf_hyper_fn as j_hyper_fn,
    radam_update as j_radam_update,
)
from indoor_nerf_tpu_torch.bridge import state_to_numpy
from indoor_nerf_tpu_torch.data.pipeline import BatchedRaySampler
from indoor_nerf_tpu_torch.models.field import sigma_query
from indoor_nerf_tpu_torch.ops import blockhash as tbh
from indoor_nerf_tpu_torch.ops.occupancy import occupancy_update
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.train.optim import (
    exp_decay_lr,
    init_radam_state,
    named_leaves,
    radam_update,
)
from indoor_nerf_tpu_torch.train.step import train_step
from indoor_nerf_tpu_torch.train.trainer import train

torch.set_num_threads(1)

T = torch.from_numpy
N_RAYS = 64


@pytest.fixture
def f32_scatter(monkeypatch):
    """The JAX fused backward through its f32-accumulating Pallas kernel."""
    monkeypatch.setattr(jbh, "_FORCE_PALLAS_SCATTER_INTERPRET", True)


def _encode_configs(dtype):
    kw = dict(bbox_min=(-1.0, -1.2, -0.8), bbox_max=(1.1, 1.0, 1.3),
              n_levels=4, n_features_per_level=4, log2_rows=7,
              base_resolution=4, finest_resolution=32, block_size=3,
              gather_dtype=dtype, scatter_dtype=dtype)
    return jbh.BlockHashConfig(**kw), tbh.BlockHashConfig(**kw)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_encode_backward_matches_jax(rng, f32_scatter, dtype):
    """d table of <feats, c> for a fixed cotangent c: both sides form the
    same entries (bf16: bitwise the same rounded products) and differ only
    in the order of the f32 sums, so 1e-5. float32 goes through XLA
    autodiff on the JAX side (products in another order: one ulp)."""
    jcfg, tcfg = _encode_configs(dtype)
    x = rng.uniform(-1.3, 1.4, size=(300, 3)).astype(np.float32)
    table = rng.standard_normal((4 * 128, 256)).astype(np.float32)
    c = rng.standard_normal((300, tcfg.out_dim)).astype(np.float32)

    want = jax.grad(lambda t: jnp.sum(
        jbh.block_hash_encode(jnp.asarray(x), t, jcfg)[0] * c))(jnp.asarray(table))
    tt = T(table).requires_grad_(True)
    feats, _ = tbh.block_hash_encode(T(x), tt, tcfg)
    (got,) = torch.autograd.grad(feats, tt, grad_outputs=T(c))
    assert got.dtype == torch.float32 and got.shape == tt.shape
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_block_tv_loss_and_grad_match_jax(rng):
    """Same rows (the JAX draw replayed): value and gradient differ only by
    summation order, so 1e-5 relative."""
    jcfg, tcfg = _encode_configs("bfloat16")
    table = rng.standard_normal((4 * 128, 256)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    rows = (np.asarray(jax.random.randint(key, (4, 128), 0, 128))
            + np.arange(4)[:, None] * 128).reshape(-1)

    want, want_g = jax.value_and_grad(
        lambda t: jbh.block_tv_loss(key, t, jcfg))(jnp.asarray(table))
    tt = T(table).requires_grad_(True)
    got = tbh.block_tv_loss(tt, tcfg, T(rows))
    (got_g,) = torch.autograd.grad(got, tt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-6)
    # The draw: m = min(256, R) rows per level, each inside its level.
    drawn = tbh.draw_tv_rows(torch.Generator().manual_seed(0), tcfg)
    assert drawn.shape == (4 * 128,)
    assert torch.equal(drawn // 128, torch.arange(4).repeat_interleave(128))


def test_occupancy_update_matches_jax(rng):
    """Cells drawn once: the JAX value (sigma summation order only, 1e-5).
    Cells drawn more than once: the largest of their fresh values, where
    the JAX .at[].set keeps an unspecified one. Undrawn cells decay
    exactly."""
    jcfg, tcfg, _ = configs()
    jstate, tstate = both_states(jcfg, occ_rng=rng)
    table = rng.standard_normal(jstate["params"]["table"].shape).astype(np.float32)
    jstate["params"]["table"] = jnp.asarray(table)
    tstate["params"]["table"] = T(table)
    joc, toc = jcfg.render.occupancy, tcfg.render.occupancy
    key = jax.random.PRNGKey(9)
    draws = jax_step_draws(key, jcfg, 1, 0)  # the refresh keys of step 0
    _, _, _, k_occ = jax.random.split(key, 4)

    def j_sigma(pts):
        return j_sigma_query(jstate["params"], "coarse", pts, jcfg.render.field)

    want = np.asarray(j_occupancy_update(k_occ, jstate["occ"], j_sigma, joc)["density"])
    with torch.no_grad():
        got = occupancy_update(
            tstate["occ"],
            lambda pts: sigma_query(tstate["params"], "coarse", pts,
                                    tcfg.render.field),
            toc, draws["occ_cells"], draws["occ_jitter"])["density"].numpy()

    cells = draws["occ_cells"].numpy()
    g = toc.resolution
    ijk = np.stack([(cells // (g * g)) % g, (cells // g) % g, cells % g],
                   -1).astype(np.float32)
    bmin = np.asarray(toc.bbox_min, np.float32)
    bmax = np.asarray(toc.bbox_max, np.float32)
    pts = bmin + (ijk + draws["occ_jitter"].numpy()) / g * (bmax - bmin)
    decayed = np.asarray(jstate["occ"]["density"]) * np.float32(toc.decay)
    fresh = np.maximum(decayed[cells],
                       np.maximum(np.asarray(j_sigma(jnp.asarray(pts))), 0.0))
    uniq, counts = np.unique(cells, return_counts=True)
    once, dup = uniq[counts == 1], uniq[counts > 1]
    assert len(dup) > 10 and len(once) > 100
    np.testing.assert_allclose(got[once], want[once], rtol=1e-5, atol=1e-6)
    best = np.full(decayed.shape, -np.inf, np.float32)
    np.maximum.at(best, cells, fresh)
    np.testing.assert_allclose(got[dup], best[dup], rtol=1e-5, atol=1e-6)
    untouched = np.setdiff1d(np.arange(decayed.size), uniq)
    np.testing.assert_array_equal(got[untouched], decayed[untouched])


def test_radam_matches_jax_over_8_steps(rng):
    """Random gradients, both groups (table: eps 1e-15, no decay; MLP
    weights: decay 1e-6). Steps 1-5 leave the params unchanged (N_sma < 5
    at beta2 0.99); steps 6-8 update them. The scalar schedule is float32
    on both sides but pow/sqrt may round one ulp apart: 1e-6 relative."""
    jcfg, _, _ = configs()
    jstate, tstate = both_states(jcfg)
    jparams = jstate["params"]
    leaves = named_leaves(tstate["params"])
    jopt = j_init_radam_state(jparams)
    topt = init_radam_state(leaves)
    init = {k: v.detach().clone() for k, v in leaves.items()}
    flat_j, treedef = jax.tree_util.tree_flatten_with_path(jparams)
    names = [".".join(str(getattr(p, "key", getattr(p, "idx", None)))
                      for p in path) for path, _ in flat_j]
    assert sorted(names) == sorted(leaves)
    for step in range(8):
        grads = {n: rng.standard_normal(leaves[n].shape).astype(np.float32)
                 * (1e-3 if n == "table" else 1.0) for n in names}
        grads["table"][::2] = 0.0  # rows no point touched this step
        lr = exp_decay_lr(0.01, 250, step)
        np.testing.assert_allclose(
            lr, float(j_exp_decay_lr(0.01, 250, jnp.asarray(step))), rtol=1e-7)
        jg = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(grads[n]) for n in names])
        jparams, jopt = j_radam_update(jg, jopt, jparams, jnp.float32(lr),
                                       j_hyper_fn)
        radam_update(leaves, {n: T(g) for n, g in grads.items()}, topt, lr)
        assert topt["step"] == int(jopt["step"]) == step + 1
        for n, jp, jm, jn in zip(
                names, jax.tree_util.tree_leaves(jparams),
                jax.tree_util.tree_leaves(jopt["mu"]),
                jax.tree_util.tree_leaves(jopt["nu"])):
            np.testing.assert_allclose(topt["mu"][n].numpy(), np.asarray(jm),
                                       rtol=1e-6, atol=1e-12, err_msg=n)
            np.testing.assert_allclose(topt["nu"][n].numpy(), np.asarray(jn),
                                       rtol=1e-6, atol=1e-15, err_msg=n)
            np.testing.assert_allclose(leaves[n].detach().numpy(),
                                       np.asarray(jp), rtol=1e-6, atol=1e-9,
                                       err_msg=n)
            moved = not torch.equal(leaves[n].detach(), init[n])
            assert moved == (step >= 5), (n, step)


def test_train_step_matches_jax(f32_scatter):
    """One flagship step (tiny size) from one state with the JAX draws.

    loss: summation orders only, 1e-5. The refreshed grid reads the same
    (not yet updated) params: 1e-5. Moments: the MLP leaves to 1e-4
    (f32 backward sums in other orders); the table's gradient entries are
    rounded to bf16 before the f32 sum, so a cotangent one f32 ulp apart
    can round to the neighbouring bf16 value and move that entry's sum by
    one bf16 ulp (2^-8) of one term: the table's mu is held at 2^-8 of its
    largest entry, nu (which squares the sum) at 2^-7, and both at 1e-3
    relative in norm."""
    check_train_step_matches_jax()


def test_train_8_steps_match_jax_params(f32_scatter):
    """Eight steps from one state, new rays and replayed draws each step;
    RAdam moves the params at steps 6-8. A table entry moves by
    lr * rect * mu / sqrt(nu), a ratio of O(1) whatever the gradient's
    scale (eps 1e-15), so an entry whose few bf16-rounded terms nearly
    cancel can move the other way on one side. So the table is held at
    twice the largest move per entry, at 5e-2 of lr for all but 0.1% of
    the entries, and at 1e-2 of the total move in norm; the MLP leaves at
    1e-4 relative (f32 summation orders only)."""
    jcfg, tcfg, scene = configs()
    jstate, tstate = both_train_states(jcfg)
    start = jax_train_state_numpy(jstate)["params"]
    sampler = jax_batch_sampler(scene, N_RAYS, seed=1)
    step_fn = jax_step_fn(jcfg)
    key = jax.random.PRNGKey(11)
    for step in range(8):
        key, sub = jax.random.split(key)
        b = sampler.next()
        batch = {k: b[k] for k in ("rays_o", "rays_d", "target")}
        jstate, _ = step_fn(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, sub)
        tstate, _ = train_step(tstate, {k: T(v) for k, v in batch.items()}, tcfg,
                               draws=jax_step_draws(sub, jcfg, N_RAYS, step))
    want = jax_train_state_numpy(jstate)["params"]
    got = state_to_numpy(tstate)["params"]
    lr = float(jcfg.lrate)
    for k in ("coarse",):
        assert_tree_close(got[k], want[k], 1e-4, k)
    moved = want["table"] - start["table"]
    assert np.abs(moved).max() > 0.1 * lr
    diff = np.abs(got["table"] - want["table"])
    assert diff.max() <= 2 * np.abs(moved).max()
    assert np.mean(diff > 5e-2 * lr) <= 1e-3
    assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(moved)


def test_batched_sampler_copy_is_identical():
    _, _, scene = configs()
    H, W, _ = scene.hwf
    args = (scene.images, scene.poses, scene.i_train, H, W, scene.K, 4000)
    j, t = JBatchedRaySampler(*args, seed=3), BatchedRaySampler(*args, seed=3)
    for _ in range(12):  # crosses an epoch: the pool holds 9 x 64 x 64 rays
        a, b = j.next(), t.next()
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_trainer_runs_the_cli_on_cpu(capsys):
    args = parse_args(TINY_FLAGSHIP + CPU + ["--N_rand", "64", "--n_iters", "3",
                                       "--i_print", "2", "--lrate", "0.01"])
    out = train(args)
    assert len(out["losses"]) == 3 and np.all(np.isfinite(out["losses"]))
    assert out["state"]["step"] == 3
    text = capsys.readouterr().out
    assert "[TRAIN] Iter: 2" in text and "[TRAIN] Iter: 3" in text


@pytest.mark.parametrize("flag,item", [
    (["--multihost"], "torchrun's environment"),
    (["--mesh_shape", "data:2"], "started with --multihost"),
])
def test_trainer_refuses_unported_flags(flag, item, monkeypatch):
    """Multi-device training is ported (ROADMAP Queue 1 item 8); the
    trainer refuses its flags where no process group can be formed: no
    rendezvous for --multihost, a mesh of two ranks in one process."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    args = parse_args(TINY_FLAGSHIP + CPU + flag + ["--n_iters", "1"])
    with pytest.raises(ValueError, match=item):
        train(args)


@pytest.mark.parametrize("flag", [
    ["--reg_views", "1", "--reg_mode", "planar"],
    ["--reg_views", "2"],
    ["--use_appearance"],
    ["--render_only", "--render_test", "--render_fit_appearance"],
])
def test_trainer_runs_the_reg_and_appearance_flags(flag, capsys):
    """The flags of Queue 1 item 5c, which the trainer refused before it
    was ported, run: two steps, or a render-only run with the half-image
    fit (from the seeded field: no --expname)."""
    args = parse_args(TINY_FLAGSHIP + CPU + flag + [
        "--N_rand", "32", "--n_iters", "2", "--synthetic_res", "16"])
    out = train(args)
    text = capsys.readouterr().out
    if args.render_only:
        assert "[fit-appearance] mean right-half PSNR" in text
        assert np.isfinite(out["fit_appearance"]["mean_fitted"])
        return
    assert out["state"]["step"] == 2 and np.all(np.isfinite(out["losses"]))
    assert ("[reg] unobserved-view depth TV" in text) == (args.reg_views > 0)
    assert ("appearance" in out["state"]["params"]) == args.use_appearance


def test_trainer_names_the_loop_flags_without_effect(capsys, tmp_path):
    """The loop flags that did nothing before the loop was ported now take
    effect, and no line names a flag as without effect: --i_testset renders
    the held-out views, --i_video the render path; --i_img is read by
    neither package's trainer; --render_factor acts with --render_only."""
    base = TINY_FLAGSHIP + CPU + ["--N_rand", "64", "--n_iters", "1"]
    out = train(parse_args(base + [
        "--i_weights", "50", "--i_testset", "1", "--i_video", "1",
        "--i_img", "7", "--no_reload", "--render_factor", "2",
        "--basedir", str(tmp_path / "runs"), "--expname", "verify"]))
    assert "without effect" not in capsys.readouterr().out
    assert out["logdir"].startswith(str(tmp_path / "runs"))
    files = os.listdir(out["logdir"])
    assert sorted(f for f in files if f.endswith(".ckpt")) == \
        ["000001.ckpt", "best.ckpt"]
    assert "testset_000001" in files and [t["step"] for t in out["testsets"]] == [1]
    assert any(f.startswith("verify") and "_spiral_000001_rgb" in f
               for f in files)

