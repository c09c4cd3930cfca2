"""Shared set-up of the port's parity tests: one CLI, both packages.

The same flags go through the JAX and the port ``build_train_config``; the
JAX package initialises the weights, and the port receives the same arrays
through ``indoor_nerf_tpu_torch.bridge``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from indoor_nerf_tpu.data.load import load_dataset as j_load_dataset
from indoor_nerf_tpu.data.pipeline import BatchedRaySampler as JBatchedRaySampler
from indoor_nerf_tpu.train.config import parse_args as j_parse_args
from indoor_nerf_tpu.train.step import init_train_state, train_step as j_train_step
from indoor_nerf_tpu.train.trainer import build_train_config as j_build
from indoor_nerf_tpu_torch.bridge import (
    params_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from indoor_nerf_tpu_torch.data.load import load_dataset as t_load_dataset
from indoor_nerf_tpu_torch.data.pipeline import ImageRaySampler
from indoor_nerf_tpu_torch.train.config import parse_args as t_parse_args
from indoor_nerf_tpu_torch.train.step import train_step
from indoor_nerf_tpu_torch.train.trainer import build_train_config as t_build

# The flagship preset at test size: 4 levels x 4 features, 2^7 rows per
# level, finest_res 32, a 16^3 occupancy grid.
TINY_FLAGSHIP = [
    "--flagship", "--dataset_type", "synthetic", "--use_viewdirs",
    "--white_bkgd", "--n_levels", "4", "--finest_res", "32",
    "--log2_hashmap_size", "12", "--occ_resolution", "16",
    "--occ_candidates", "32", "--occ_samples", "8",
]
# The port's entry points run on the card unless told otherwise; the CPU
# tests tell them (the JAX parser does not know the flag).
CPU = ["--device", "cpu"]
# The rays of a parity step's batch.
N_RAYS = 64
# The hash grid with the hierarchical fine pass (test_torch_parity_path.py's
# TINY_PARITY).
TINY_HASH = ["--dataset_type", "synthetic", "--use_viewdirs", "--white_bkgd",
             "--n_levels", "4", "--finest_res", "32", "--log2_hashmap_size",
             "12", "--N_samples", "8", "--N_importance", "8",
             "--raw_noise_std", "1"]



def configs(flags=TINY_FLAGSHIP):
    """(JAX TrainConfig, port TrainConfig, port SceneData) for one CLI, each
    package's config built from its own parser's namespace."""
    jargs, targs = j_parse_args(list(flags)), t_parse_args(list(flags))
    scene = t_load_dataset(targs)
    return j_build(jargs, j_load_dataset(jargs)), t_build(targs, scene), scene


def jax_state_numpy(jcfg, seed=0, occ_rng=None):
    """The JAX initial state's serving leaves as numpy; with ``occ_rng`` the
    occupancy density is a random grid (so sampling is not uniform)."""
    state = init_train_state(jax.random.PRNGKey(seed), jcfg)
    tree = {"params": jax.tree_util.tree_map(np.asarray, state["params"]),
            "occ": None}
    if state["occ"] is not None:
        density = np.asarray(state["occ"]["density"])
        if occ_rng is not None:
            density = occ_rng.exponential(2.0, density.shape).astype(np.float32)
        tree["occ"] = {"density": density}
    return tree


def both_states(jcfg, seed=0, occ_rng=None):
    """(JAX state dict of jnp arrays, port state) holding the same values."""
    tree = jax_state_numpy(jcfg, seed, occ_rng)
    jstate = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    return jstate, params_from_numpy(tree)


def jax_train_state_numpy(jstate):
    """A JAX train state's leaves that the port carries, as numpy (the
    params EMA and the quantizers where the state keeps them)."""
    keys = ("params", "opt", "occ", "step", "best_loss", "loss_ema",
            "loss_ema_slow", "infl_ema")
    for key in ("ema", "quant"):
        if jstate.get(key) is not None:
            keys += (key,)
    return jax.tree_util.tree_map(np.asarray, {k: jstate[k] for k in keys})


def both_train_states(jcfg, seed=0):
    """(JAX train state, port train state) holding the same values."""
    jstate = init_train_state(jax.random.PRNGKey(seed), jcfg)
    return jstate, state_from_numpy(jax_train_state_numpy(jstate))


def jax_render_draws(k_render, jcfg, n_rays):
    """The draws the JAX ``render_rays(k_render)`` of a training render of
    ``n_rays`` rays makes: the key splits of render/renderer.py:89,
    ops/sampling.py (the stratified jitter, the fine pass's inverse-CDF
    draws), ops/occupancy.py and ops/volume.py:56 (the sigma noise of each
    pass), as ``draw_render`` returns them (numpy)."""
    rc = jcfg.render
    oc = rc.occupancy
    k_strat, k_pdf, k_noise0, k_noise1 = jax.random.split(k_render, 4)
    draws = {}
    if oc is not None:
        k_cand, k_occ_pdf = jax.random.split(k_strat)
        S = rc.n_occ_samples
        xi = np.asarray(jax.random.uniform(k_occ_pdf, (n_rays, S)))
        draws["t_rand"] = np.asarray(
            jax.random.uniform(k_cand, (n_rays, oc.n_candidates)))
        draws["u"] = (np.arange(S, dtype=np.float32) + xi) / np.float32(S)
    else:
        S = rc.n_samples
        if rc.perturb > 0:
            draws["t_rand"] = np.asarray(
                jax.random.uniform(k_strat, (n_rays, S)))
        if rc.n_importance > 0 and rc.perturb != 0:
            n = rc.n_importance
            xi = np.asarray(jax.random.uniform(k_pdf, (n_rays, n)))
            draws["u"] = (np.arange(n, dtype=np.float32) + xi) / np.float32(n)
    if rc.raw_noise_std > 0:
        std = np.float32(rc.raw_noise_std)
        draws["sigma_noise"] = np.asarray(
            jax.random.normal(k_noise0, (n_rays, S))) * std
        if oc is None and rc.n_importance > 0:
            draws["sigma_noise1"] = np.asarray(jax.random.normal(
                k_noise1, (n_rays, S + rc.n_importance))) * std
    return draws


def jax_step_draws(key, jcfg, n_rays, step, with_coords=False, n_reg=0):
    """The draws the JAX ``train_step(key)`` makes at ``step``, replayed
    for the port's ``draws=``: the key splits of train/step.py:187, the
    main render's (``jax_render_draws``), ops/tv.py:42-51 (the hash grid's
    cube origins), losses/priors.py (``jax_prior_draws``, once the priors
    are active; ``with_coords`` where the batch has ``spatial_coords``),
    ops/occupancy.py:102,142 and, for ``n_reg`` patch rays, the patch
    render's of ``k_reg = fold_in(key, 17)`` (:191) under ``"reg"``."""
    rc = jcfg.render
    oc = rc.occupancy
    fc = rc.field
    k_render, k_tv, k_priors, k_occ = jax.random.split(key, 4)
    draws = jax_render_draws(k_render, jcfg, n_rays)
    tv_on = jcfg.tv_loss_weight > 0 and step <= jcfg.tv_cutoff_iter
    if tv_on and fc.i_embed == 3:
        bg = fc.block_grid
        L, R = bg.n_levels, bg.rows_per_level
        rows = jax.random.randint(k_tv, (L, min(256, R)), 0, R) \
            + jnp.arange(L, dtype=jnp.int32)[:, None] * R
        draws["tv_rows"] = np.asarray(rows).reshape(-1).astype(np.int64)
    if tv_on and fc.i_embed == 1:
        draws["tv_origins"] = jax_tv_origins(k_tv, fc.grid)
    if oc is not None and step % oc.update_interval == 0:
        k_cell, k_jit = jax.random.split(k_occ)
        m = int(oc.n_cells * oc.update_fraction)
        draws["occ_cells"] = np.asarray(jax.random.randint(
            k_cell, (m,), 0, oc.n_cells, jnp.int32)).astype(np.int64)
        draws["occ_jitter"] = np.asarray(jax.random.uniform(k_jit, (m, 3)))
    out = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    if jcfg.reg_depth_tv_weight > 0 and n_reg > 0:
        out["reg"] = {k: torch.from_numpy(np.array(v)) for k, v in
                      jax_render_draws(jax.random.fold_in(key, 17), jcfg,
                                       n_reg).items()}
    if (jcfg.use_structural_priors and fc.predict_normals
            and step >= jcfg.structural_loss_start_iter):
        out["priors"] = {k: torch.from_numpy(np.array(v)) for k, v in
                         jax_prior_draws(k_priors, n_rays, with_coords,
                                         jcfg.priors).items()}
    return out


def jax_prior_draws(k_priors, n, with_coords, config):
    """The draws the JAX ``combine_structural_losses(k_priors)`` makes for
    an ``n``-ray batch (losses/priors.py:89,215-218,256,269), as
    ``draw_priors`` returns them."""
    k_frame, k_planar, k_consist = jax.random.split(k_priors, 3)
    draws = {"centers": np.asarray(jax.random.normal(k_frame, (3, 3)))}
    if n < 10:
        return draws
    for name, k, m in zip(("floor", "wall", "other"),
                          jax.random.split(k_planar, 3),
                          (config.n_pairs_floor, config.n_pairs_wall,
                           config.n_pairs_other)):
        draws[f"planar_{name}"] = np.asarray(
            jax.random.randint(k, (2, m), 0, n)).astype(np.int64)
    if with_coords:
        m, hi = min(config.n_pairs_consistency, n // 2), n
    else:
        m, hi = min(100, n - 1), n - 1
    draws["consist_idx"] = np.asarray(
        jax.random.randint(k_consist, (m,), 0, hi)).astype(np.int64)
    return draws


def jax_tv_origins(k_tv, grid):
    """The cube origins ``[L, 3]`` the JAX ``total_variation_loss(k_tv)``
    draws (ops/tv.py:42-51)."""
    from indoor_nerf_tpu.ops.encoding import level_resolutions
    from indoor_nerf_tpu.ops.tv import _level_cube_size

    res = level_resolutions(grid)
    keys = jax.random.split(k_tv, grid.n_levels)
    return np.stack([np.asarray(jax.random.randint(
        keys[level], (3,), 0,
        int(res[level]) - _level_cube_size(res[level], grid.base_resolution),
        dtype=jnp.int32)) for level in range(grid.n_levels)]).astype(np.int64)


def jax_batch_sampler(scene, n, seed=0):
    """The JAX package's ray sampler over the scene's training views."""
    H, W, _ = scene.hwf
    return JBatchedRaySampler(scene.images, scene.poses, scene.i_train, H, W,
                              scene.K, n, seed=seed)


def jax_step_fn(jcfg):
    return jax.jit(functools.partial(j_train_step, config=jcfg))


def assert_tree_close(got, want, rtol, what):
    """Each leaf within ``rtol`` relative, and ``rtol`` of its largest
    entry absolute (entries near zero carry the absolute error of sums
    of larger terms)."""
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()),
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def check_train_step_matches_jax(flags=TINY_FLAGSHIP, n_rays=64):
    """One step of both packages from one state with the JAX draws, held to
    the tolerances ``test_train_step_matches_jax`` states. The caller sets
    the JAX encode backward's f32-accumulating Pallas path."""
    jcfg, tcfg, scene = configs(flags)
    jstate, tstate = both_train_states(jcfg)
    b = jax_batch_sampler(scene, n_rays).next()
    batch = {k: b[k] for k in ("rays_o", "rays_d", "target")}
    key = jax.random.PRNGKey(5)
    jnew, jm = jax_step_fn(jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    tnew, tm = train_step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                          tcfg, draws=jax_step_draws(key, jcfg, n_rays, 0))
    for k in ("loss", "img_loss", "psnr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-7)
    want = jax_train_state_numpy(jnew)
    got = state_to_numpy(tnew)
    assert int(got["step"]) == 1 and int(got["opt"]["step"]) == 1
    for k in ("loss_ema", "loss_ema_slow", "best_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["occ"]["density"], want["occ"]["density"],
                               rtol=1e-5, atol=1e-6)
    for key_, tol in (("mu", 2.0 ** -8), ("nu", 2.0 ** -7)):
        mlp_got = {k: v for k, v in got["opt"][key_].items() if k != "table"}
        mlp_want = {k: v for k, v in want["opt"][key_].items() if k != "table"}
        assert_tree_close(mlp_got, mlp_want, 1e-4, key_)
        gt, wt = got["opt"][key_]["table"], want["opt"][key_]["table"]
        scale = float(np.abs(wt).max())
        assert scale > 0.0
        np.testing.assert_allclose(gt, wt, rtol=0, atol=tol * scale)
        assert np.linalg.norm(gt - wt) <= 1e-3 * np.linalg.norm(wt)
    # RAdam's first step leaves every parameter where it was.
    assert_tree_close(got["params"], jax_train_state_numpy(jstate)["params"],
                      0, "params")


def step_batch(scene, with_coords, seed=1):
    """The first batch of the image sampler (with its pixels' coordinates,
    as ``--no_batching`` trains) or of the shuffled pool."""
    if with_coords:
        H, W, _ = scene.hwf
        b = ImageRaySampler(scene.images, scene.poses, scene.i_train, H, W,
                            scene.K, N_RAYS, seed=seed).next(1)
        return {k: b[k] for k in ("rays_o", "rays_d", "target", "spatial_coords")}
    b = jax_batch_sampler(scene, N_RAYS, seed=seed).next()
    return {k: b[k] for k in ("rays_o", "rays_d", "target")}


def one_step(flags, step=0, with_coords=False, prior_weights=None, key=5,
             edit=None, extra=None):
    """One step of both packages from one state (its step counter set to
    ``step``; the table O(1) from a seed, so that the field is opaque and
    the table's own terms are not lost under the image loss; ``edit``, if
    given, maps the JAX state to the one both start from) on one batch
    with the JAX draws; ``extra``, if given, maps the scene to more arrays
    of the batch (the patch rays ``reg_rays_o``/``reg_rays_d``, whose
    count sets the patch render's draws, and ``img_idx``). Returns (JAX
    metrics, port metrics, JAX state before and after as numpy, port state
    after as numpy, the port step's draws)."""
    jcfg, tcfg, scene = configs(flags)
    jstate, _ = both_train_states(jcfg)
    table = np.random.default_rng(7).standard_normal(
        jstate["params"]["table"].shape).astype(np.float32)
    jstate = {**jstate, "step": jnp.asarray(step, jnp.int32),
              "params": {**jstate["params"], "table": jnp.asarray(table)}}
    if jstate.get("ema") is not None:
        jstate["ema"] = jstate["params"]
    if edit is not None:
        jstate = edit(jstate)
    tstate = state_from_numpy(jax_train_state_numpy(jstate))
    batch = step_batch(scene, with_coords)
    if extra is not None:
        batch.update(extra(scene))
    n_reg = len(batch["reg_rays_o"]) if "reg_rays_o" in batch else 0
    k = jax.random.PRNGKey(key)
    before = jax_train_state_numpy(jstate)
    kw = {}
    if prior_weights is not None:
        kw["prior_weights"] = {n: jnp.float32(v) for n, v in prior_weights.items()}
    jnew, jm = jax_step_fn(jcfg)(
        jstate, {n: jnp.asarray(v) for n, v in batch.items()}, k, **kw)
    draws = jax_step_draws(k, jcfg, N_RAYS, step, with_coords, n_reg)
    tnew, tm = train_step(tstate,
                          {n: torch.from_numpy(v) for n, v in batch.items()},
                          tcfg, draws=draws, prior_weights=prior_weights)
    return jm, tm, before, jax_train_state_numpy(jnew), \
        state_to_numpy(tnew), draws


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
