"""The params bridge: JAX state -> port -> numpy is bitwise the JAX state."""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (
    TINY_FLAGSHIP,
    configs,
    jax_state_numpy,
    jax_train_state_numpy,
)
from indoor_nerf_tpu.train.step import init_train_state
from indoor_nerf_tpu_torch.bridge import (
    params_from_numpy,
    params_to_numpy,
    state_from_numpy,
    state_to_numpy,
)
from indoor_nerf_tpu_torch.models.field import init_field_params

torch.set_num_threads(1)

# The block-hash defaults at test size (block_size 4, 2 features per level,
# f32 table IO: [L*R, 256] rows, the layout of the --use_pallas path).
TINY_BLOCK4 = [
    "--i_embed", "3", "--use_occupancy", "--N_importance", "0",
    "--occ_weighting", "transmittance", "--dataset_type", "synthetic",
    "--use_viewdirs", "--white_bkgd", "--n_levels", "4", "--finest_res", "32",
    "--log2_hashmap_size", "14", "--occ_resolution", "16",
    "--occ_candidates", "32", "--occ_samples", "8", "--use_pallas",
]


@pytest.mark.parametrize("flags", [TINY_FLAGSHIP, TINY_BLOCK4],
                         ids=["flagship", "block4_f32"])
@pytest.mark.parametrize("with_occ_rng", [False, True])
def test_round_trip_is_bitwise(rng, with_occ_rng, flags):
    jcfg, tcfg, _ = configs(flags)
    bg = tcfg.render.field.block_grid
    assert (bg.block_size, bg.n_features_per_level, bg.gather_dtype) == (
        (3, 4, "bfloat16") if flags is TINY_FLAGSHIP else (4, 2, "float32"))
    tree = jax_state_numpy(jcfg, seed=3, occ_rng=rng if with_occ_rng else None)
    assert tree["params"]["table"].shape == (
        bg.n_levels * bg.rows_per_level,
        bg.n_features_per_level * bg.lanes_per_feature)
    back = params_to_numpy(params_from_numpy(tree))
    flat, treedef = jax.tree_util.tree_flatten(tree)
    flat_back, treedef_back = jax.tree_util.tree_flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_bridged_params_have_the_port_init_shapes():
    jcfg, tcfg, _ = configs()
    bridged = params_from_numpy(jax_state_numpy(jcfg))["params"]
    own = init_field_params(torch.Generator().manual_seed(0), tcfg.render.field)
    assert bridged.keys() == own.keys()
    assert bridged["table"].shape == own["table"].shape
    assert {k: v.shape for k, v in bridged["coarse"].state_dict().items()} == \
        {k: v.shape for k, v in own["coarse"].state_dict().items()}


def test_biased_layers_are_refused():
    tree = {"params": {"table": np.zeros((2, 2), np.float32),
                       "coarse": {"sigma_net": [{"w": np.zeros((2, 2)),
                                                 "b": np.zeros(2)}],
                                  "color_net": []}}}
    with pytest.raises(ValueError, match="bias-free"):
        params_from_numpy(tree)


@pytest.mark.parametrize("flags", [TINY_FLAGSHIP, TINY_BLOCK4],
                         ids=["flagship", "block4_f32"])
def test_train_state_round_trip_is_bitwise(rng, flags):
    """Params, RAdam moments and counters, occ and the loss EMAs."""
    jcfg, _, _ = configs(flags)
    tree = jax_train_state_numpy(init_train_state(jax.random.PRNGKey(1), jcfg))
    # Non-trivial moments, counters and EMAs.
    tree = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape).astype(a.dtype)
                   if a.dtype == np.float32 else a + 7), tree)
    state = state_from_numpy(tree)
    assert state["step"] == 7 and state["opt"]["step"] == 7
    assert all(t.requires_grad for t in
               [state["params"]["table"], *state["params"]["coarse"].parameters()])
    back = state_to_numpy(state)
    flat, treedef = jax.tree_util.tree_flatten(tree)
    flat_back, treedef_back = jax.tree_util.tree_flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
