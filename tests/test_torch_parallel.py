"""Port parity: multi-device training and rendering, in CPU processes over
Gloo, against the port's single-process path and the JAX ``parallel/``.

The port side runs in spawned children (``_torch_parallel_child.py``, one
process per rank, a file rendezvous under ``tmp_path``; they import no
jax); the JAX side and the port's single-process reference run in the test
process, the JAX meshes on the virtual CPU devices of ``conftest.py``.
States go through ``bridge``; the draws replay the JAX key splits, and
every step of either side draws for the global batch. Each group of
children runs once per module (``--dist loadfile`` keeps a file on one
worker) and several tests read what it produced.
"""

import glob
import os
import re
import subprocess
import sys

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
    jax_batch_sampler,
    jax_step_draws,
    jax_train_state_numpy,
)
from indoor_nerf_tpu.data.pipeline import BatchedRaySampler as JBatchedRaySampler
from indoor_nerf_tpu.data.synthetic import make_synthetic_scene
from indoor_nerf_tpu.models.field import FieldConfig as JFieldConfig
from indoor_nerf_tpu.ops.encoding import HashGridConfig as JHashGridConfig
from indoor_nerf_tpu.ops.occupancy import OccupancyConfig as JOccupancyConfig
from indoor_nerf_tpu.parallel.shard import (
    make_mesh as j_make_mesh,
    make_sharded_train_step as j_make_sharded_train_step,
    replicate_state as j_replicate_state,
    state_shardings as j_state_shardings,
)
from indoor_nerf_tpu.parallel.sp import (
    make_sharded_image_renderer as j_make_sharded_image_renderer,
)
from indoor_nerf_tpu.render.renderer import RenderConfig as JRenderConfig
from indoor_nerf_tpu.train.step import (
    TrainConfig as JTrainConfig,
    init_train_state as j_init_train_state,
)
from indoor_nerf_tpu_torch.bridge import (
    params_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from indoor_nerf_tpu_torch.models.field import FieldConfig
from indoor_nerf_tpu_torch.ops.encoding import HashGridConfig
from indoor_nerf_tpu_torch.ops.occupancy import OccupancyConfig
from indoor_nerf_tpu_torch.parallel import shard
from indoor_nerf_tpu_torch.parallel.dryrun import dryrun_multichip
from indoor_nerf_tpu_torch.render.renderer import RenderConfig, render_image
from indoor_nerf_tpu_torch.train.step import TrainConfig, train_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_parallel_child.py")
ENV = dict(os.environ,
           PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
N_FLAG = 64  # rays of a flagship step's global batch
N_FULL = 128  # of the full-feature step's
HW = (12, 10)  # the sharded renders


def run_ranks(tmpdir, job, world, timeout=240):
    """Run ``job`` on ``world`` child processes; their saved results."""
    os.makedirs(tmpdir, exist_ok=True)
    job_path = os.path.join(tmpdir, "job.pt")
    torch.save(job, job_path)
    rdv = os.path.join(tmpdir, "rendezvous")
    outs = [os.path.join(tmpdir, f"rank{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, CHILD, job_path, str(r), str(world), rdv, outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=ENV) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(o, weights_only=False) for o in outs]


@pytest.fixture(scope="module")
def f32_scatter():
    """The JAX fused backward through its f32-accumulating Pallas kernel
    (the port's numerics; test_torch_train_step.py)."""
    old = jbh._FORCE_PALLAS_SCATTER_INTERPRET
    jbh._FORCE_PALLAS_SCATTER_INTERPRET = True
    yield
    jbh._FORCE_PALLAS_SCATTER_INTERPRET = old


def _steps_case(name, jcfg, tcfg, jstate, batches, keys, n_rays, start=0):
    """A ``steps`` case: the bridged state (its step counter at ``start``),
    the global batches and each step's global JAX draws."""
    state = jax_train_state_numpy(jstate)
    state["step"] = np.int32(start)
    return {"name": name, "kind": "steps", "cfg": tcfg, "state": state,
            "batches": batches,
            "draws": [jax_step_draws(k, jcfg, n_rays, start + s)
                      for s, k in enumerate(keys)]}


def _keys(n):
    key, out = jax.random.PRNGKey(1), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(sub)
    return out


def port_single(case):
    """The port's single-process steps of a case on its whole batches."""
    state = state_from_numpy(case["state"], "cpu")
    metrics = []
    for batch, draws in zip(case["batches"], case["draws"]):
        state, m = train_step(state, {k: torch.as_tensor(v)
                                      for k, v in batch.items()},
                              case["cfg"], draws=draws)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state_to_numpy(state)


def jax_sharded(jcfg, jstate, batches, keys, mesh, model_axis=None):
    """JAX ``make_sharded_train_step`` over ``mesh``: (losses, state)."""
    if model_axis is None:
        state = j_replicate_state(jstate, mesh)
    else:
        state = jax.device_put(
            jstate, j_state_shardings(jstate, mesh, model_axis))
    step = j_make_sharded_train_step(jcfg, mesh, model_axis=model_axis,
                                     donate=False, state_template=state)
    losses = []
    for b, k in zip(batches, keys):
        state, m = step(state, {n: jnp.asarray(v) for n, v in b.items()}, k)
        losses.append(float(m["loss"]))
    return losses, jax_train_state_numpy(state)


# ---- the flagship's set-up, and the full-feature one of test_sharding.py ---

def flagship_setup(n_steps=3, flags=TINY_FLAGSHIP):
    jcfg, tcfg, scene = configs(flags)
    jstate = j_init_train_state(jax.random.PRNGKey(0), jcfg)
    sampler = jax_batch_sampler(scene, N_FLAG)
    batches = [{k: b[k] for k in ("rays_o", "rays_d", "target")}
               for b in (sampler.next() for _ in range(n_steps))]
    return jcfg, tcfg, jstate, batches, _keys(n_steps)


def full_feature_configs(scene):
    """The setup of JAX tests/test_sharding.py:85-145 (hash grid, normals,
    quantization, transmittance occupancy, priors, A-CAQ, distortion) in
    both packages."""
    def build(Grid, Occ, Field, Render, Train):
        grid = Grid(bbox_min=tuple(scene["bbox_min"]),
                    bbox_max=tuple(scene["bbox_max"]), n_levels=4,
                    log2_hashmap_size=12, base_resolution=16,
                    finest_resolution=64)
        occ = Occ(bbox_min=tuple(scene["bbox_min"]),
                  bbox_max=tuple(scene["bbox_max"]), resolution=16,
                  update_interval=2, warmup_steps=0,
                  weighting="transmittance")
        fc = Field(grid=grid, i_embed=1, predict_normals=True,
                   use_quantization=True)
        rc = Render(field=fc, n_samples=16, white_bkgd=True, occupancy=occ,
                    n_occ_samples=12)
        return Train(render=rc, near=float(scene["near"]),
                     far=float(scene["far"]), n_rand=N_FULL,
                     tv_loss_weight=1e-6, tv_cutoff_iter=100,
                     use_structural_priors=True, structural_loss_start_iter=1,
                     structural_loss_ramp_iters=2, use_acaq=True,
                     acaq_start_iter=1, acaq_interval=2,
                     distortion_loss_weight=1e-3)

    return (build(JHashGridConfig, JOccupancyConfig, JFieldConfig,
                  JRenderConfig, JTrainConfig),
            build(HashGridConfig, OccupancyConfig, FieldConfig, RenderConfig,
                  TrainConfig))


def full_feature_setup(n_steps=4):
    scene = make_synthetic_scene(n_views=6, H=32, W=32)
    jcfg, tcfg = full_feature_configs(scene)
    jstate = j_init_train_state(jax.random.PRNGKey(0), jcfg)
    H, W, _ = scene["hwf"]
    sampler = JBatchedRaySampler(scene["images"], scene["poses"],
                                 scene["i_split"][0], H, W, scene["K"],
                                 N_FULL)
    batches = [{k: b[k] for k in ("rays_o", "rays_d", "target")}
               for b in (sampler.next() for _ in range(n_steps))]
    return jcfg, tcfg, jstate, batches, _keys(n_steps)


def render_case(name, tcfg, state_np, model_sharded):
    """A render of the state's MLPs with a table of unit normal entries:
    the seeded init's entries of 1e-4 render an image that is uniform to
    3e-5, which no gather order could change."""
    table = state_np["params"]["table"]
    params = dict(state_np["params"], table=np.random.default_rng(4).normal(
        0.0, 1.0, table.shape).astype(np.float32))
    H, W = HW
    K = np.array([[14.0, 0, W / 2], [0, 14.0, H / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 4.0
    return {"name": name, "kind": "render", "cfg": tcfg.render.test_mode(),
            "params": params, "occ": state_np["occ"]["density"],
            "model_sharded": model_sharded, "hw": HW, "K": K, "c2w": c2w,
            "near": tcfg.near, "far": tcfg.far, "tile_rays": 16}


def render_single(case):
    """The single-process render of a render case (the port's)."""
    params = params_from_numpy({"params": case["params"]}, "cpu")["params"]
    occ = {"density": torch.as_tensor(case["occ"])}
    H, W = case["hw"]
    return render_image(params, H, W, case["K"], case["c2w"], case["near"],
                        case["far"], case["cfg"], tile_rays=64, occ_state=occ)


# ---- the children: data:2 (flagship, full feature, render) and data:2 x
# model:2 (flagship with TP, render with the model-sharded table) ----------

@pytest.fixture(scope="module")
def dp(tmp_path_factory, f32_scatter):
    flag = flagship_setup()
    full = full_feature_setup()
    cases = [_steps_case("flagship", *flag[:3], flag[3], flag[4], N_FLAG),
             _steps_case("full", *full[:3], full[3], full[4], N_FULL)]
    cases.append(render_case("render", flag[1],
                             cases[0]["state"] | {"occ": {
                                 "density": np.random.default_rng(3)
                                 .exponential(2.0, 16 ** 3)
                                 .astype(np.float32)}}, False))
    job = {"axes": ("data",), "sizes": (2,), "cases": cases}
    res = run_ranks(str(tmp_path_factory.mktemp("dp")), job, 2)
    return {"flag": flag, "full": full, "cases": cases, "ranks": res}


# Under a model axis, beside the flagship: A-CAQ from step 600 (past the
# block grid quantizer's 500-step warmup; 600 is a controller step), the
# int8 gather, and the hash grid through tp_hash_encode.
TP_VARIANTS = {
    "acaq": (TINY_FLAGSHIP + ["--use_quantization", "--use_acaq",
                              "--acaq_start_iter", "1"], 600),
    "int8": (TINY_FLAGSHIP + ["--block_io", "int8"], 0),
    "hash": (TINY_HASH, 0),
}


@pytest.fixture(scope="module")
def tp(tmp_path_factory, f32_scatter):
    flag = flagship_setup()
    case = _steps_case("flagship", *flag[:3], flag[3], flag[4], N_FLAG)
    rcase = render_case("render", flag[1], case["state"] | {"occ": {
        "density": np.random.default_rng(3).exponential(2.0, 16 ** 3)
        .astype(np.float32)}}, True)
    variants = []
    for name, (flags, start) in TP_VARIANTS.items():
        v = flagship_setup(2, flags)
        variants.append(_steps_case(name, *v[:3], v[3], v[4], N_FLAG, start))
    job = {"axes": ("data", "model"), "sizes": (2, 2),
           "cases": [case, rcase] + variants}
    res = run_ranks(str(tmp_path_factory.mktemp("tp")), job, 4)
    return {"flag": flag, "cases": job["cases"], "ranks": res}


def _losses(rank_result, name):
    return [float(m["loss"]) for m in rank_result[name]["metrics"]]


def _replicated(local):
    """The leaves every rank must hold bit for bit: all but the table and
    its moments (a model axis shards those)."""
    out = {k: v for k, v in local.items() if k not in ("params", "opt",
                                                       "ema")}
    out["params"] = {k: v for k, v in local["params"].items() if k != "table"}
    out["opt"] = {m: {k: v for k, v in local["opt"][m].items()
                      if k != "table"} for m in ("mu", "nu")}
    return out


def _assert_trees_equal(a, b, what):
    for (path, x), y in zip(jax.tree_util.tree_flatten_with_path(a)[0],
                            jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{what} "
                                      f"{jax.tree_util.keystr(path)}")


def hold_moments(got, want, tol_scale=1.0):
    """The table's RAdam moments as the step parity tests hold them
    (bf16-rounded gradient terms summed in another order: mu 2^-8 and nu
    2^-7 of the largest entry, 1e-3 in norm), the MLP's 1e-4 of each
    leaf's largest entry."""
    for key_, tol in (("mu", 2.0 ** -8), ("nu", 2.0 ** -7)):
        g, w = got["opt"][key_], want["opt"][key_]
        assert_tree_close({k: v for k, v in g.items() if k != "table"},
                          {k: v for k, v in w.items() if k != "table"},
                          1e-4, key_)
        scale = float(np.abs(w["table"]).max())
        assert scale > 0.0
        np.testing.assert_allclose(g["table"], w["table"], rtol=0,
                                   atol=tol * tol_scale * scale)
        assert np.linalg.norm(g["table"] - w["table"]) <= \
            1e-3 * tol_scale * np.linalg.norm(w["table"])


# ---- data:2, the flagship ---------------------------------------------------

def test_dp_losses_identical_across_ranks(dp):
    r0, r1 = dp["ranks"]
    assert r0["coords"] == (0,) and r1["coords"] == (1,)
    for name, n in (("flagship", 3), ("full", 4)):
        assert len(_losses(r0, name)) == n
        assert _losses(r0, name) == _losses(r1, name), name


def test_dp_replicated_state_identical_across_ranks(dp):
    r0, r1 = dp["ranks"]
    for name in ("flagship", "full"):
        _assert_trees_equal(r0[name]["local"], r1[name]["local"], name)


def test_dp_flagship_matches_single_process(dp):
    """data:2 equals the port's one-process step on the concatenated batch:
    loss 1e-5 relative, the moments as the parity tests hold them, the
    grid's density 1e-5."""
    want_m, want = port_single(dp["cases"][0])
    got = dp["ranks"][0]["flagship"]["full"]
    np.testing.assert_allclose(_losses(dp["ranks"][0], "flagship"),
                               [m["loss"] for m in want_m], rtol=1e-5)
    hold_moments(got, want)
    np.testing.assert_allclose(got["occ"]["density"], want["occ"]["density"],
                               rtol=1e-5, atol=1e-6)
    assert int(got["step"]) == 3 and int(got["opt"]["step"]) == 3


def test_dp_flagship_matches_jax_sharded_step(dp):
    """Against JAX ``make_sharded_train_step`` on two devices (the JAX
    global-view step), at the step parity tests' tolerances."""
    jcfg, _, jstate, batches, keys = dp["flag"]
    losses, want = jax_sharded(jcfg, jstate, batches, keys,
                               j_make_mesh(jax.devices()[:2]))
    np.testing.assert_allclose(_losses(dp["ranks"][0], "flagship"), losses,
                               rtol=1e-5)
    got = dp["ranks"][0]["flagship"]["full"]
    hold_moments(got, want)
    np.testing.assert_allclose(got["occ"]["density"], want["occ"]["density"],
                               rtol=1e-5, atol=1e-6)


# ---- data:2, every feature of test_sharding.py's full-feature step --------

def test_dp_full_feature_matches_world_one(dp):
    """Priors, occupancy, quantization, A-CAQ and distortion: world 2
    against world 1 at JAX's own tolerances (losses 3e-4, density 1e-4,
    the grid quantizers' soft bits 1e-6)."""
    want_m, want = port_single(dp["cases"][1])
    got = dp["ranks"][0]["full"]["full"]
    np.testing.assert_allclose(_losses(dp["ranks"][0], "full"),
                               [m["loss"] for m in want_m], rtol=3e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got["occ"]["density"], want["occ"]["density"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["quant"]["embed"]["soft_bits"],
                               want["quant"]["embed"]["soft_bits"], rtol=1e-6)
    # The controller moved the bits on its steps (2, at interval 2).
    assert not np.allclose(got["quant"]["embed"]["soft_bits"],
                           dp["cases"][1]["state"]["quant"]["embed"]
                           ["soft_bits"])


def test_dp_full_feature_matches_jax(dp):
    jcfg, _, jstate, batches, keys = dp["full"]
    losses, want = jax_sharded(jcfg, jstate, batches, keys,
                               j_make_mesh(jax.devices()[:2]))
    got = dp["ranks"][0]["full"]["full"]
    np.testing.assert_allclose(_losses(dp["ranks"][0], "full"), losses,
                               rtol=3e-4, atol=1e-6)
    np.testing.assert_allclose(got["occ"]["density"], want["occ"]["density"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["quant"]["embed"]["soft_bits"],
                               want["quant"]["embed"]["soft_bits"], rtol=1e-6)


# ---- data:2 x model:2, the flagship with the table sharded by level -------

def test_tp_losses_identical_across_ranks(tp):
    losses = [_losses(r, "flagship") for r in tp["ranks"]]
    assert all(l == losses[0] for l in losses), losses
    assert [r["coords"] for r in tp["ranks"]] == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]
    for r in tp["ranks"][1:]:
        _assert_trees_equal(_replicated(tp["ranks"][0]["flagship"]["local"]),
                            _replicated(r["flagship"]["local"]), "replicated")


def test_tp_table_is_sharded_by_level(tp):
    """Each rank holds [L*R/2, W] of the table, mu and nu: its level block,
    which the gathered state puts back in place."""
    full = tp["cases"][0]["state"]["params"]["table"].shape
    for r in tp["ranks"]:
        local = r["flagship"]["local"]
        for leaf in (local["params"]["table"], local["opt"]["mu"]["table"],
                     local["opt"]["nu"]["table"]):
            assert leaf.shape == (full[0] // 2, full[1])
    for r in tp["ranks"]:
        j = r["coords"][1]
        gathered = r["flagship"]["full"]["opt"]["mu"]["table"]
        np.testing.assert_array_equal(
            gathered[j * full[0] // 2:(j + 1) * full[0] // 2],
            r["flagship"]["local"]["opt"]["mu"]["table"])


def test_tp_flagship_matches_single_process(tp):
    want_m, want = port_single(tp["cases"][0])
    got = tp["ranks"][0]["flagship"]["full"]
    np.testing.assert_allclose(_losses(tp["ranks"][0], "flagship"),
                               [m["loss"] for m in want_m], rtol=1e-5)
    hold_moments(got, want)
    np.testing.assert_allclose(got["params"]["table"],
                               want["params"]["table"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["occ"]["density"], want["occ"]["density"],
                               rtol=1e-5, atol=1e-6)


def test_tp_flagship_matches_jax(tp):
    """Against JAX's data:2 x model:2 step with the table and its moments
    sharded over the model axis (tests/test_sharding.py:220 at this
    size)."""
    jcfg, _, jstate, batches, keys = tp["flag"]
    mesh = j_make_mesh(jax.devices()[:4], ("data", "model"), (2, 2))
    losses, want = jax_sharded(jcfg, jstate, batches, keys, mesh, "model")
    got = tp["ranks"][0]["flagship"]["full"]
    np.testing.assert_allclose(_losses(tp["ranks"][0], "flagship"), losses,
                               rtol=1e-5)
    hold_moments(got, want)
    np.testing.assert_allclose(got["occ"]["density"], want["occ"]["density"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(TP_VARIANTS))
def test_tp_variant_steps_match_single_process(tp, name):
    """A-CAQ (each rank quantizes its own levels; the embed quantizers of
    all levels gathered back), the int8 gather (per-level scales of the
    local levels) and the hash grid (tp_hash_encode) under data:2 x
    model:2, against the port's one-process steps: losses 1e-5 relative,
    the moments as the parity tests hold them (the hash table's 1e-4, as
    the MLPs'), the quantizers 1e-6; every rank's replicated state the
    same."""
    case = next(c for c in tp["cases"] if c["name"] == name)
    want_m, want = port_single(case)
    ranks = tp["ranks"]
    got = ranks[0][name]["full"]
    losses = _losses(ranks[0], name)
    np.testing.assert_allclose(losses, [m["loss"] for m in want_m],
                               rtol=1e-5)
    if name == "hash":
        assert_tree_close(got["opt"], want["opt"], 1e-4, "opt")
    else:
        hold_moments(got, want)
    if "quant" in want:
        assert_tree_close(got["quant"], want["quant"], 1e-6, "quant")
        assert not np.allclose(want["quant"]["embed"]["soft_bits"],
                               case["state"]["quant"]["embed"]["soft_bits"])
    for r in ranks[1:]:
        assert _losses(r, name) == losses
        _assert_trees_equal(_replicated(ranks[0][name]["local"]),
                            _replicated(r[name]["local"]), name)


# ---- the sharded renderer ---------------------------------------------------

@pytest.mark.parametrize("which", ["dp", "tp"])
def test_sharded_render_matches_single_process(which, request):
    """Rays over every rank (2 and 4), the image on every rank; with the
    model-sharded table gathered per call: rgb within 1e-5 of the
    single-process render."""
    run = request.getfixturevalue(which)
    case = next(c for c in run["cases"] if c["name"] == "render")
    want = render_single(case)
    for r in run["ranks"]:
        got = r["render"]
        assert got["rgb_map"].shape == HW + (3,)
        np.testing.assert_allclose(got["rgb_map"], want["rgb_map"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["depth_map"], want["depth_map"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got["rgb_map"],
                                      run["ranks"][0]["render"]["rgb_map"])


def test_sharded_render_matches_jax(tp):
    """Against JAX ``make_sharded_image_renderer`` on its data:2 x model:2
    mesh with the table level-sharded: rgb 2e-5 (both gather the rows in
    bf16 and weigh them in f32 on the CPU; the sums' order differs), on an
    image whose rgb spans 1e4 times that; depth 3e-4 relative (a weight's
    f32 error moves the depth by up to far - near times it)."""
    case = next(c for c in tp["cases"] if c["name"] == "render")
    jcfg = tp["flag"][0]
    mesh = j_make_mesh(jax.devices()[:4], ("data", "model"), (2, 2))
    H, W = HW
    render = j_make_sharded_image_renderer(jcfg.render, H, W, mesh,
                                           tile_rays=16, model_axis="model")
    params = jax.tree_util.tree_map(jnp.asarray, case["params"])
    want = render(params, jnp.asarray(case["c2w"]), jnp.asarray(case["K"]),
                  case["near"], case["far"],
                  occ_state={"density": jnp.asarray(case["occ"])})
    got = tp["ranks"][0]["render"]
    assert np.ptp(got["rgb_map"]) > 1e4 * 2e-5
    np.testing.assert_allclose(got["rgb_map"], np.asarray(want["rgb_map"]),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["depth_map"],
                               np.asarray(want["depth_map"]), rtol=3e-4,
                               atol=1e-5)


# ---- the trainer under --multihost, two processes --------------------------

TRAINER_FLAGS = TINY_FLAGSHIP + CPU + [
    "--expname", "mh", "--N_rand", "64", "--lrate", "0.01", "--i_print",
    "5", "--i_weights", "10", "--i_testset", "15", "--i_video", "100000",
    "--testskip", "4", "--synthetic_res", "16"]


def _trainer(basedir, rdv, n_iters, world, mesh_shape):
    """``world`` trainer processes joined through the file rendezvous
    ``rdv`` (a TCP port could be taken by another test worker)."""
    argv = [sys.executable, "-m", "indoor_nerf_tpu_torch.train.trainer", "--",
            *TRAINER_FLAGS, "--basedir", basedir, "--n_iters", str(n_iters),
            "--multihost", "--coordinator_address", f"file://{rdv}",
            "--num_processes", str(world), "--mesh_shape", mesh_shape]
    procs = [subprocess.Popen(argv + ["--process_id", str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO,
                              env=dict(ENV, OMP_NUM_THREADS="1"))
             for i in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def multihost(tmp_path_factory):
    basedir = str(tmp_path_factory.mktemp("mh"))
    rdv = tmp_path_factory.mktemp("mh_rdv")
    first = _trainer(basedir, str(rdv / "first"), 15, 2, "data:2")
    resumed = _trainer(basedir, str(rdv / "resumed"), 20, 2, "model:2")
    return {"basedir": basedir, "first": first, "resumed": resumed}


LOSS_RE = re.compile(r"\[TRAIN\] Iter: (\d+) Loss: ([0-9.eE+-]+)")


def test_multihost_trainer_two_processes(multihost):
    outs = multihost["first"]
    for i, out in enumerate(outs):
        assert f"[multihost] process {i}/2 backend=gloo" in out
        assert "Device mesh: {'data': 2}" in out
    losses = [dict(LOSS_RE.findall(o)) for o in outs]
    assert sorted(losses[0], key=int) == ["5", "10", "15"]
    assert losses[0] == losses[1]
    assert all(np.isfinite(float(v)) for v in losses[0].values())


def test_multihost_only_rank_zero_writes(multihost):
    outs = multihost["first"]
    logdirs = glob.glob(os.path.join(multihost["basedir"], "mh*"))
    assert len(logdirs) == 1
    names = sorted(os.listdir(logdirs[0]))
    for want in ("000010.ckpt", "000015.ckpt", "args.txt", "metrics",
                 "testset_000015", "training_metrics.pkl"):
        assert want in names, names
    assert "Saved checkpoints at" in outs[0]
    assert "Saved checkpoints at" not in outs[1]
    assert not glob.glob(os.path.join(logdirs[0], "*.tmp"))


def test_multihost_checkpoint_serves_in_one_process(multihost):
    """The checkpoint of a sharded run holds the single-device state: a
    one-process server of the same flags loads it."""
    from indoor_nerf_tpu_torch import serve

    args = serve.parse_server_args(
        ["--width", "8", "--height", "8", "--"] + TRAINER_FLAGS
        + ["--basedir", multihost["basedir"], "--n_iters", "15"])
    render, step, _ = serve.build(args)[:3]
    assert step == 20  # the resumed run's last checkpoint


def test_multihost_resumes_under_another_mesh(multihost):
    """The data:2 run's step-15 checkpoint resumes under model:2 (the table
    re-sharded by level) and trains on to step 20; both ranks agree."""
    outs = multihost["resumed"]
    for out in outs:
        assert "Device mesh: {'model': 2}" in out
        assert "Resumed at step 15" in out
    losses = [dict(LOSS_RE.findall(o)) for o in outs]
    assert list(losses[0]) == ["20"] and losses[0] == losses[1]


# ---- the dry run, and the refusals ------------------------------------------

def test_dryrun_multichip_four_processes():
    line = dryrun_multichip(4, device="cpu")
    assert line.startswith("dryrun_multichip(4): ok, device=cpu, "
                           "mesh=data:2 x model:2")
    assert "tp table-sharded=True" in line


def test_parse_mesh_shape():
    assert shard.parse_mesh_shape(None, 4) == (("data",), (4,))
    assert shard.parse_mesh_shape("data:4,model:2", 8) == (
        ("data", "model"), (4, 2))
    assert shard.parse_mesh_shape("data,model:2", 8) == (
        ("data", "model"), (4, 2))
    assert shard.parse_mesh_shape("model:2", 2) == (("model",), (2,))


def test_make_mesh_refusals():
    """One process, no process group: a mesh of one rank has no groups (its
    collectives are the identity); more ranks need --multihost."""
    mesh = shard.make_mesh(("data", "model"), (1, 1))
    assert mesh.world_size == 1 and mesh.groups == {}
    assert mesh.index("model") == 0 and mesh.size("data") == 1
    with pytest.raises(ValueError, match="--multihost"):
        shard.make_mesh(("data",), (2,))
    with pytest.raises(ValueError, match="axes"):
        shard.make_mesh(("pipe",), (1,))
    _, tcfg, _ = configs(TINY_FLAGSHIP)
    fake = shard.Mesh(("data", "model"), (1, 3), 0, (0, 0), {})
    with pytest.raises(ValueError, match="divide"):
        shard.check_mesh(fake, tcfg.render.field)
    _, gcfg, _ = configs(TINY_FLAGSHIP + ["--ray_groups", "2,2,1,1"])
    fake2 = shard.Mesh(("data", "model"), (1, 2), 0, (0, 0), {})
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        shard.check_mesh(fake2, gcfg.render.field)
    shard.check_mesh(fake2, tcfg.render.field)
