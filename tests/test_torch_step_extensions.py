"""Port parity: the training step's extensions against the JAX ``train_step``
(the structural priors on the block-hash and the hash-grid paths, the
distortion loss, the table decay, the params EMA, the level and view
anneals), with the JAX draws replayed and the JAX encode backward through
its f32-accumulating Pallas scatter in interpret mode, as
``test_torch_train_step.py`` runs it; and the trainer's prior schedule
(countdown, activation banner, ``[PRIOR]`` lines, overfitting decay) on a
tiny run."""

import argparse
import functools

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
    both_train_states,
    configs,
    jax_batch_sampler,
    jax_step_draws,
    jax_step_fn,
    jax_train_state_numpy,
)
from indoor_nerf_tpu.models.field import level_anneal_weights as j_level_weights
from indoor_nerf_tpu_torch import bridge
from indoor_nerf_tpu_torch.data.pipeline import ImageRaySampler
from indoor_nerf_tpu_torch.losses.distortion import distortion_loss
from indoor_nerf_tpu_torch.models.field import level_anneal_weights
from indoor_nerf_tpu_torch.train import trainer
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.train.step import (
    draw_step,
    eval_params,
    prior_ramp_weights,
    train_step,
)

torch.set_num_threads(1)
T = torch.from_numpy
N_RAYS = 64
# The hash grid with the hierarchical fine pass (test_torch_parity_path.py's
# TINY_PARITY).
TINY_HASH = ["--dataset_type", "synthetic", "--use_viewdirs", "--white_bkgd",
             "--n_levels", "4", "--finest_res", "32", "--log2_hashmap_size",
             "12", "--N_samples", "8", "--N_importance", "8",
             "--raw_noise_std", "1"]
# The priors from step 3 over a ramp of 4: a step at 5 weighs them 0.55.
PRIORS = ["--use_structural_priors", "--predict_normals",
          "--structural_loss_start_iter", "3",
          "--structural_loss_ramp_iters", "4"]
# configs/norcliffe_common_room.txt's base weights.
NORCLIFFE_WEIGHTS = {"depth_prior": 0.0, "planarity": 0.001,
                     "manhattan": 0.0005, "normal_consistency": 0.0002}


@pytest.fixture(autouse=True)
def f32_scatter(monkeypatch):
    """The JAX fused backward through its f32-accumulating Pallas kernel."""
    monkeypatch.setattr(jbh, "_FORCE_PALLAS_SCATTER_INTERPRET", True)


def _batch(scene, with_coords, seed=1):
    """The first batch of the image sampler (with its pixels' coordinates,
    as ``--no_batching`` trains) or of the shuffled pool."""
    if with_coords:
        H, W, _ = scene.hwf
        b = ImageRaySampler(scene.images, scene.poses, scene.i_train, H, W,
                            scene.K, N_RAYS, seed=seed).next(1)
        return {k: b[k] for k in ("rays_o", "rays_d", "target", "spatial_coords")}
    b = jax_batch_sampler(scene, N_RAYS, seed=seed).next()
    return {k: b[k] for k in ("rays_o", "rays_d", "target")}


def one_step(flags, step=0, with_coords=False, prior_weights=None, key=5):
    """One step of both packages from one state (its step counter set to
    ``step``; the table O(1) from a seed, so that the field is opaque and
    the table's own terms are not lost under the image loss) on one batch
    with the JAX draws. Returns (JAX metrics, port metrics, JAX state
    before and after as numpy, port state after as numpy, the port step's
    draws)."""
    jcfg, tcfg, scene = configs(flags)
    jstate, _ = both_train_states(jcfg)
    table = np.random.default_rng(7).standard_normal(
        jstate["params"]["table"].shape).astype(np.float32)
    jstate = {**jstate, "step": jnp.asarray(step, jnp.int32),
              "params": {**jstate["params"], "table": jnp.asarray(table)}}
    if jstate.get("ema") is not None:
        jstate["ema"] = jstate["params"]
    tstate = bridge.state_from_numpy(jax_train_state_numpy(jstate))
    batch = _batch(scene, with_coords)
    k = jax.random.PRNGKey(key)
    before = jax_train_state_numpy(jstate)
    kw = {}
    if prior_weights is not None:
        kw["prior_weights"] = {n: jnp.float32(v) for n, v in prior_weights.items()}
    jnew, jm = jax_step_fn(jcfg)(
        jstate, {n: jnp.asarray(v) for n, v in batch.items()}, k, **kw)
    draws = jax_step_draws(k, jcfg, N_RAYS, step, with_coords)
    tnew, tm = train_step(tstate, {n: T(v) for n, v in batch.items()}, tcfg,
                          draws=draws, prior_weights=prior_weights)
    return jm, tm, before, jax_train_state_numpy(jnew), \
        bridge.state_to_numpy(tnew), draws


def hold_step(jm, tm, want, got, block_table):
    """The tolerances of the existing step parity tests: loss, image loss
    and PSNR 1e-5 relative; the MLP moments 1e-4 of each leaf's largest
    entry; the block table's moments as ``test_train_step_matches_jax``
    states (bf16-rounded gradient terms: mu 2^-8 and nu 2^-7 of the largest
    entry, 1e-3 in norm), the hash table's 1e-4 like the MLPs'."""
    for k in ("loss", "img_loss", "psnr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    for key_, tol in (("mu", 2.0 ** -8), ("nu", 2.0 ** -7)):
        g, w = got["opt"][key_], want["opt"][key_]
        assert_tree_close({k: v for k, v in g.items() if k != "table"},
                          {k: v for k, v in w.items() if k != "table"},
                          1e-4, key_)
        if not block_table:
            assert_tree_close(g["table"], w["table"], 1e-4, key_)
            continue
        scale = float(np.abs(w["table"]).max())
        assert scale > 0.0
        np.testing.assert_allclose(g["table"], w["table"], rtol=0,
                                   atol=tol * scale)
        assert np.linalg.norm(g["table"] - w["table"]) <= \
            1e-3 * np.linalg.norm(w["table"])


PRIOR_CASES = {
    "block_hash": (TINY_FLAGSHIP, False),
    "block_hash_coords": (TINY_FLAGSHIP, True),
    "hash_fine_coords": (TINY_HASH, True),
}


@pytest.mark.parametrize("name", sorted(PRIOR_CASES))
def test_priors_step_matches_jax(name):
    """One step with the priors active, in their ramp (step 5 of a ramp
    from 3 over 4: weights 0.55 of norcliffe's base weights), on the block
    hash (with and without the pixels' coordinates) and on the hash grid
    with the fine pass (whose coarse pass's normals the step also
    composites, ``normal0``). The step is held as the other step tests hold
    theirs, and the priors' diagnostics too: the floor and wall counts
    exactly, each weighted term 1e-4 relative. The counts come from
    thresholds on the rendered normals, which both sides compute through
    the net: a normal within f32 rounding of a threshold could flip one of
    them; the test would show it here, and no seed was chosen to avoid it."""
    flags, coords = PRIOR_CASES[name]
    jm, tm, before, want, got, draws = one_step(
        flags + PRIORS, step=5, with_coords=coords,
        prior_weights=NORCLIFFE_WEIGHTS)
    assert "priors" in draws and ("consist_idx" in draws["priors"])
    assert draws["priors"]["consist_idx"].shape == ((32,) if coords else (63,))
    hold_step(jm, tm, want, got, block_table=flags is TINY_FLAGSHIP)
    for k in ("structural_semantic_floor_count", "structural_semantic_wall_count"):
        assert int(tm[k]) == int(jm[k]), k
    assert int(tm["structural_semantic_floor_count"]) + \
        int(tm["structural_semantic_wall_count"]) > 0
    for k in ("structural_manhattan", "structural_planarity",
              "structural_normal_consistency"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
        assert float(jm[k]) > 0.0, k
    w = prior_ramp_weights(configs(flags + PRIORS)[1], 5, NORCLIFFE_WEIGHTS)
    assert w == pytest.approx({"manhattan": 0.55 * 0.0005, "planarity": 0.55 * 0.001,
                               "normal_consistency": 0.55 * 0.0002}, rel=1e-6)
    # The normal net of the last pass got the priors' gradient (the coarse
    # pass's normals, normal0, enter no loss, in JAX neither).
    last = "fine" if "fine" in got["opt"]["mu"] else "coarse"
    assert float(np.abs(got["opt"]["mu"][last]["normal_net"][0]["w"]).max()) > 0


def test_priors_wait_for_their_start():
    """Before ``structural_loss_start_iter`` the step draws nothing for the
    priors and adds nothing: it equals JAX's zero branch."""
    jm, tm, _, want, got, draws = one_step(TINY_FLAGSHIP + PRIORS, step=2)
    assert "priors" not in draws and "structural_manhattan" not in tm
    assert float(jm["structural_manhattan"]) == 0.0
    hold_step(jm, tm, want, got, block_table=True)


EXTENSIONS = {
    "distortion": (["--distortion_loss_weight", "0.01"], 0),
    "table_decay": (["--table_decay_weight", "0.1"], 0),
    "level_anneal": (["--freq_anneal_iters", "8"], 3),
    "view_anneal": (["--view_anneal_iters", "8"], 3),
}


@pytest.mark.parametrize("name", sorted(EXTENSIONS))
def test_extension_step_matches_jax(name):
    """One flagship step with one extension on (the anneals at step 3 of 8:
    levels 0-1 fully on, level 2 at a quarter, view encoding at 3/8),
    held as the flagship step is held."""
    extra, step = EXTENSIONS[name]
    jm, tm, _, want, got, _ = one_step(TINY_FLAGSHIP + extra, step=step)
    hold_step(jm, tm, want, got, block_table=True)
    base = _base_step(step)
    # It acts: on the loss, or (the anneals) on what the step renders.
    assert abs(float(tm["loss"]) - float(base["loss"])) > 1e-6 * float(base["loss"])


@functools.lru_cache(maxsize=None)
def _base_step(step):
    """The port's metrics of ``one_step`` without any extension."""
    return one_step(TINY_FLAGSHIP, step=step)[1]


def test_level_anneal_weights_match_jax():
    for step in (0, 1, 3, 5, 8, 20):
        want = np.asarray(j_level_weights(jnp.asarray(step, jnp.int32), 8, 6))
        np.testing.assert_array_equal(level_anneal_weights(step, 8, 6).numpy(),
                                      want)


def test_distortion_loss_matches_jax(rng):
    from indoor_nerf_tpu.losses.distortion import distortion_loss as j_dist

    z = np.sort(rng.uniform(2, 6, (50, 16)), -1).astype(np.float32)
    w = rng.uniform(0, 0.2, (50, 16)).astype(np.float32)
    near, far = np.full((50, 1), 2.0, np.float32), np.full((50, 1), 6.0, np.float32)
    want = float(j_dist(*map(jnp.asarray, (w, z, near, far))))
    got = float(distortion_loss(*map(T, (w, z, near, far))))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_ema_matches_jax_at_radams_first_move():
    """The hash grid with the fine pass and ``--ema_decay 0.9``: five steps
    of both (every loss 1e-5; RAdam holds the params, so the EMA stays at
    them), then the sixth, RAdam's first move, from the JAX state on both
    sides: the EMA takes a tenth of the move. Its MLP leaves 1e-5 relative;
    its table where the JAX first moment is resolved (at least 1e-3 of the
    largest) to 1e-2 of its move, as ``test_torch_parity_path.py::
    _hold_first_move`` holds the table's move (elsewhere the entry moves
    by noise over noise)."""
    jcfg, tcfg, scene = configs(TINY_HASH + ["--ema_decay", "0.9"])
    jstate, tstate = both_train_states(jcfg)
    assert tstate["ema"] is not None and eval_params(tstate) is tstate["ema"]
    sampler = jax_batch_sampler(scene, N_RAYS, seed=1)
    step_fn = jax_step_fn(jcfg)
    key = jax.random.PRNGKey(5)
    for step in range(6):
        key, sub = jax.random.split(key)
        b = sampler.next()
        batch = {k: b[k] for k in ("rays_o", "rays_d", "target")}
        draws = jax_step_draws(sub, jcfg, N_RAYS, step)
        if step == 5:
            before = jax_train_state_numpy(jstate)
            tstate = bridge.state_from_numpy(before)
        jstate, jm = step_fn(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                             sub)
        tstate, tm = train_step(tstate, {k: T(v) for k, v in batch.items()},
                                tcfg, draws=draws)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss at step {step}")
    want_state = jax_train_state_numpy(jstate)
    want, got = want_state["ema"], bridge.state_to_numpy(tstate)["ema"]
    for k in ("coarse", "fine"):
        assert_tree_close(got[k], want[k], 1e-5, k)
    moved = want["table"] - before["ema"]["table"]
    mu = np.abs(want_state["opt"]["mu"]["table"])
    resolved = mu >= 1e-3 * mu.max()
    assert np.abs(moved).max() > 0 and resolved.mean() > 0.3
    np.testing.assert_allclose((got["table"] - before["ema"]["table"])[resolved],
                               moved[resolved], rtol=1e-2, atol=0)


def test_draw_step_draws_the_priors_once_active():
    _, tcfg, _ = configs(TINY_FLAGSHIP + PRIORS)
    gen = torch.Generator().manual_seed(0)
    assert "priors" not in draw_step(gen, tcfg, 2, 64, True)
    d = draw_step(gen, tcfg, 3, 64, True)["priors"]
    assert d["centers"].shape == (3, 3) and d["consist_idx"].shape == (32,)
    assert draw_step(gen, tcfg, 4, 64, False)["priors"]["consist_idx"].shape == (63,)


def test_pe_with_structural_priors_is_refused():
    """PE's NeRFBig predicts no normals; the JAX package fails on the pair
    when it traces the step. The port says so before it builds anything."""
    args = parse_args(["--dataset_type", "synthetic", "--i_embed", "0",
                       "--use_structural_priors", "--predict_normals",
                       "--N_rand", "16", "--n_iters", "1"] + CPU)
    with pytest.raises(ValueError, match="normals of NeRFSmall.*IndexError"):
        trainer.train(args)


TINY_TRAIN = ["--flagship", "--dataset_type", "synthetic", "--use_viewdirs",
              "--white_bkgd", "--n_levels", "2", "--finest_res", "16",
              "--log2_hashmap_size", "10", "--occ_resolution", "8",
              "--occ_candidates", "8", "--occ_samples", "4", "--N_rand", "16",
              "--testskip", "8", "--use_structural_priors"] + CPU


def test_trainer_prints_the_prior_schedule(capsys):
    """The countdown every --i_print steps of the 500 before the start, the
    banner at the start (the step after it is the first with the priors, as
    in the JAX trainer), a [PRIOR] line every --i_print steps from it; no
    decay without a test set."""
    out = trainer.train(parse_args(TINY_TRAIN + [
        "--n_iters", "10", "--i_print", "2", "--structural_loss_start_iter",
        "6", "--structural_loss_ramp_iters", "4"]))
    text = capsys.readouterr().out
    assert "AUTOMATICALLY ENABLING NORMAL PREDICTION" in text
    assert "Structural priors activate in 4 iterations" in text
    assert "Structural priors activate in 2 iterations" in text
    assert text.count("ACTIVATING STRUCTURAL PRIORS AT ITERATION 6") == 1
    prior_lines = [l for l in text.splitlines() if l.startswith("[PRIOR]")]
    assert len(prior_lines) == 2  # iterations 8 and 10 (steps 7 and 9)
    assert "floor/wall px:" in prior_lines[0] and "wall-angle:" in prior_lines[0]
    assert out["prior_decays"] == [] and out["structural_priors_start_time"]
    assert out["state"]["params"]["coarse"].predict_normals


def test_trainer_decays_the_priors_on_overfitting(capsys):
    """501 tiny steps with a threshold no run can stay under: at step 500
    (more than 500 past the start, more than 50 PSNRs logged, a test set
    rendered at 100) the weights fall by 30%, floored at the minimum."""
    out = trainer.train(parse_args(TINY_TRAIN + [
        "--n_iters", "501", "--i_print", "1", "--i_testset", "100",
        "--structural_loss_start_iter", "-1", "--overfitting_threshold",
        "-100", "--planarity_weight", "1e-5", "--min_structural_weight",
        "1e-5"]))
    assert "Overfitting detected at iteration 500" in capsys.readouterr().out
    [(step, weights)] = out["prior_decays"]
    assert step == 500 and out["prior_weights"] == weights
    assert weights == pytest.approx({"depth_prior": 0.007, "planarity": 1e-5,
                                     "manhattan": 0.0014,
                                     "normal_consistency": 0.0007})


@pytest.mark.parametrize("i,train_psnr,test_psnr,decays", [
    (1000, 30.0, 20.0, True), (1000, 30.0, 26.0, False), (999, 30.0, 20.0, False),
    (500, 30.0, 20.0, False), (1000, 30.0, None, False)])
def test_decay_rule_is_the_jax_one(i, train_psnr, test_psnr, decays):
    """JAX trainer.py:650-666: steps that are multiples of 500, more than
    500 past the start (0 here), more than 50 logged PSNRs, a test PSNR, and
    a gap above the threshold (5 dB)."""
    args = argparse.Namespace(use_structural_priors=True,
                              structural_loss_start_iter=0,
                              overfitting_threshold=5.0,
                              min_structural_weight=1e-5)
    weights = dict(NORCLIFFE_WEIGHTS)
    assert trainer.decay_prior_weights(args, i, [train_psnr] * 60, test_psnr,
                                       weights) is decays
    if decays:
        assert weights["planarity"] == pytest.approx(0.0007)
        assert weights["depth_prior"] == 1e-5  # floored
    else:
        assert weights == NORCLIFFE_WEIGHTS
