"""Shared set-up of the port's parity tests: one CLI, both packages.

The same flags go through the JAX and the port ``build_train_config``; the
JAX package initialises the weights, and the port receives the same arrays
through ``indoor_nerf_tpu_torch.bridge``.
"""

import jax
import numpy as np

from indoor_nerf_tpu.data.load import load_dataset as j_load_dataset
from indoor_nerf_tpu.train.config import parse_args
from indoor_nerf_tpu.train.step import init_train_state
from indoor_nerf_tpu.train.trainer import build_train_config as j_build
from indoor_nerf_tpu_torch.bridge import params_from_numpy
from indoor_nerf_tpu_torch.data.load import load_dataset as t_load_dataset
from indoor_nerf_tpu_torch.train.trainer import build_train_config as t_build

# The flagship preset at test size: 4 levels x 4 features, 2^7 rows per
# level, finest_res 32, a 16^3 occupancy grid.
TINY_FLAGSHIP = [
    "--flagship", "--dataset_type", "synthetic", "--use_viewdirs",
    "--white_bkgd", "--n_levels", "4", "--finest_res", "32",
    "--log2_hashmap_size", "12", "--occ_resolution", "16",
    "--occ_candidates", "32", "--occ_samples", "8",
]


def configs(flags=TINY_FLAGSHIP):
    """(JAX TrainConfig, port TrainConfig, port SceneData) for one CLI."""
    args = parse_args(list(flags))
    scene = t_load_dataset(args)
    return j_build(args, j_load_dataset(args)), t_build(args, scene), scene


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
