"""Port parity: SH encoding, NeRFSmall and the field query against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both_states, configs
from indoor_nerf_tpu.models.field import (
    init_field_params as j_init_field_params,
    query_field as j_query_field,
    sigma_query as j_sigma_query,
)
from indoor_nerf_tpu.models.mlp import (
    apply_nerf_small as j_apply_nerf_small,
    init_nerf_small as j_init_nerf_small,
)
from indoor_nerf_tpu.ops.encoding import sh_encode as j_sh_encode
from indoor_nerf_tpu_torch.bridge import params_from_numpy
from indoor_nerf_tpu_torch.models.field import (
    field_output_channels,
    init_field_params,
    query_field,
    serving_params,
    sigma_query,
)
from indoor_nerf_tpu_torch.models.mlp import apply_nerf_small
from indoor_nerf_tpu_torch.ops.encoding import sh_encode

torch.set_num_threads(1)


def _unit_dirs(rng, n):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_sh_encode_matches_jax(rng, degree):
    d = _unit_dirs(rng, 400)
    np.testing.assert_allclose(
        sh_encode(torch.from_numpy(d), degree).numpy(),
        np.asarray(j_sh_encode(jnp.asarray(d), degree)), rtol=0, atol=1e-6)


def _nerf_small_pair(seed=0):
    p = j_init_nerf_small(jax.random.PRNGKey(seed))
    tree = {"params": {"table": np.zeros((1, 1), np.float32),
                       "coarse": jax.tree_util.tree_map(np.asarray, p)}}
    return p, params_from_numpy(tree)["params"]["coarse"]


@pytest.mark.parametrize("compute,tol", [
    (None, 1e-5),  # f32: matmul summation order only
    # bf16 inputs: a 1-ulp f32 difference in a hidden activation can flip
    # its bf16 rounding (2^-8 relative) before the next layer.
    ("bfloat16", 2e-2),
])
def test_nerf_small_matches_jax(rng, compute, tol):
    jp, model = _nerf_small_pair()
    pts = rng.standard_normal((300, 32)).astype(np.float32)
    views = rng.standard_normal((300, 16)).astype(np.float32)
    want = j_apply_nerf_small(
        jp, jnp.asarray(pts), jnp.asarray(views),
        compute_dtype=None if compute is None else jnp.bfloat16)
    got = apply_nerf_small(
        model, torch.from_numpy(pts), torch.from_numpy(views),
        None if compute is None else torch.bfloat16)
    assert got.shape == (300, 4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def test_init_field_params_matches_jax_shapes():
    jcfg, tcfg, _ = configs()
    jp = j_init_field_params(jax.random.PRNGKey(0), jcfg.render.field)
    tp = init_field_params(torch.Generator().manual_seed(0), tcfg.render.field)
    assert tuple(tp["table"].shape) == jp["table"].shape
    for net in ("sigma_net", "color_net"):
        assert [tuple(l["w"].shape) for l in getattr(tp["coarse"], net)] == \
            [l["w"].shape for l in jp["coarse"][net]]
    bound = float(tp["table"].abs().max())
    assert 0 < bound <= 1e-4


@pytest.mark.parametrize("step", [None, 3])
def test_query_field_with_normals_and_anneals_matches_jax(rng, step):
    """NeRFSmall with its normal net (7 channels: rgb, sigma, the unit
    normal, kept outside the bbox where sigma is zeroed) and the level and
    view anneals of a training query at ``step`` 3 of 8 (an evaluation
    query, step None, applies neither)."""
    flags = ["--flagship", "--dataset_type", "synthetic", "--use_viewdirs",
             "--white_bkgd", "--n_levels", "4", "--finest_res", "32",
             "--log2_hashmap_size", "12", "--occ_resolution", "16",
             "--predict_normals", "--freq_anneal_iters", "8",
             "--view_anneal_iters", "8"]
    jcfg, tcfg, _ = configs(flags)
    jstate, tstate = both_states(jcfg)
    table = rng.standard_normal(jstate["params"]["table"].shape).astype(np.float32)
    jstate["params"]["table"] = jnp.asarray(table)
    tstate["params"]["table"] = torch.from_numpy(table)
    pts = rng.uniform(-1.8, 1.8, size=(40, 8, 3)).astype(np.float32)
    vd = _unit_dirs(rng, 40)
    want, _ = j_query_field(
        jstate["params"], "coarse", jnp.asarray(pts), jnp.asarray(vd),
        jcfg.render.field, train=step is not None,
        step=None if step is None else jnp.asarray(step, jnp.int32))
    with torch.no_grad():
        got, _ = query_field(tstate["params"], "coarse",
                             torch.from_numpy(pts), torch.from_numpy(vd),
                             tcfg.render.field, step)
    assert got.shape == (40, 8, field_output_channels(tcfg.render.field)) \
        == (40, 8, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    norms = np.linalg.norm(got.numpy()[..., 4:], axis=-1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)


def test_query_field_matches_jax(rng):
    """Flagship field (bf16 table gather, f32 MLP) on [R, S, 3] samples,
    some outside the bbox (sigma zeroed there)."""
    jcfg, tcfg, _ = configs()
    jstate, tstate = both_states(jcfg)
    # A table of O(1) values makes the features, not the init scale,
    # dominate the outputs.
    table = rng.standard_normal(jstate["params"]["table"].shape).astype(np.float32)
    jstate["params"]["table"] = jnp.asarray(table)
    tstate["params"]["table"] = torch.from_numpy(table)
    pts = rng.uniform(-1.8, 1.8, size=(40, 8, 3)).astype(np.float32)
    vd = _unit_dirs(rng, 40)
    want, _ = j_query_field(jstate["params"], "coarse", jnp.asarray(pts),
                            jnp.asarray(vd), jcfg.render.field, train=False)
    with torch.inference_mode():
        params = serving_params(tstate["params"], tcfg.render.field)
        got, _ = query_field(params, "coarse", torch.from_numpy(pts),
                             torch.from_numpy(vd), tcfg.render.field)
    assert got.shape == (40, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    outside = np.any(np.abs(pts) > 1.5, axis=-1)
    assert outside.any() and np.all(got.numpy()[..., 3][outside] == 0.0)

    want_s = j_sigma_query(jstate["params"], "coarse",
                           jnp.asarray(pts.reshape(-1, 3)), jcfg.render.field)
    with torch.inference_mode():
        got_s = sigma_query(params, "coarse",
                            torch.from_numpy(pts.reshape(-1, 3)),
                            tcfg.render.field)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)
