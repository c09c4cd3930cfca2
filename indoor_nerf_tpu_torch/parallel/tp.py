"""Tensor parallelism for the grids: the table sharded by level
(``parallel/tp.py`` of the JAX package).

Rank j of the model axis holds levels ``[j*L/m, (j+1)*L/m)`` of the
level-major table, computes those levels' features for every point of its
data shard, and the ``[n, (L/m)*F]`` feature slices are gathered over the
model axis (``collectives.gather_features``). The backward of the gather
is the local slice of the cotangent, so each rank's table gradient comes
from its own levels only: the scatter never leaves the level owner, and no
table gradient crosses the model axis.

The block grid's per-rank body (``tp_block_encode_local``) is the
single-device ``block_hash_encode`` of its own levels: the index math with
the full config (rows stay global, level id * R + hash, and each level's
stagger and resolution are the full grid's), the rows rebased into the
local block, and a local config of L/m levels that only the pack, the
gather and the scatter see: ``tent_contract`` forward and
``table_scatter`` backward on the local block. The int8 gather's
per-level scales come from the local levels, which are the global ones'
slice. On the tile-interp route (``--use_pallas``) the local encode is
that route's row gather and ``tile_interp``, as the JAX TP forward takes
``_gather_interp`` with ``USE_TILE_INTERP_KERNEL``.

``tp_hash_encode`` is the same design for the hash grid. The JAX trainer
leaves the sharded hash table to XLA's SPMD partitioner; the port routes
it through this function explicitly.

The card's kernels check no bounds: a row left outside the local block
would be read past it there, while the CPU's plain ``index_select``
raises on it. So the CPU tests cover every rebase.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from indoor_nerf_tpu_torch.ops.blockhash import (
    BlockHashConfig,
    block_hash_encode,
)
from indoor_nerf_tpu_torch.ops.encoding import (
    HashGridConfig,
    _CornerSum,
    corner_weights,
    hash_grid_indices,
)
from indoor_nerf_tpu_torch.parallel.collectives import (
    MODEL,
    active_mesh,
    gather_features,
    mesh_context,
)


def levels_per_rank(n_levels: int, m: int) -> int:
    """L/m, refusing a model axis that does not divide the levels."""
    if n_levels % m != 0:
        raise ValueError(f"n_levels {n_levels} not divisible by model axis {m}")
    return n_levels // m


def local_config(config, m: int):
    """The grid config of one rank's L/m levels, for the pack, the gather
    and the scatter of its block (never for the index math: the stagger
    and the resolutions are per level of the full grid)."""
    return dataclasses.replace(config,
                               n_levels=levels_per_rank(config.n_levels, m))


def tp_block_encode_local(x: torch.Tensor, table_local: torch.Tensor, j: int,
                          m: int, config: BlockHashConfig
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model rank j's share of the block-hash encode: (features ``[n,
    (L/m)*F]`` of levels ``[j*L/m, (j+1)*L/m)``, keep_mask ``[n]``).
    ``table_local`` is that level block, ``[(L/m)*R, F*lpf]`` (or its
    packed copy, in evaluation). Strided and grouped encodes are refused
    (JAX tp.py:190-194)."""
    if config.ray_strides is not None or config.ray_groups is not None:
        raise NotImplementedError(
            "ray_strides/ray_groups are not supported under tensor "
            "parallelism; train TP runs unstrided (the flagship default)")
    lp = levels_per_rank(config.n_levels, m)
    return block_hash_encode(x, table_local, config,
                             levels=range(j * lp, (j + 1) * lp),
                             table_config=local_config(config, m),
                             row_base=j * lp * config.rows_per_level)


def tp_block_encode(x: torch.Tensor, table_local: torch.Tensor,
                    config: BlockHashConfig, mesh
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The level-sharded block-hash encode over ``mesh``'s model axis
    (JAX ``tp_block_encode``, :167): this rank's levels, then the features
    gathered over the model axis -> (``[n, L*F]``, keep ``[n]``)."""
    feats, keep = tp_block_encode_local(x, table_local, mesh.index(MODEL),
                                        mesh.size(MODEL), config)
    return gather_features(feats, mesh), keep


def tp_hash_indices(x: torch.Tensor, j: int, m: int, config: HashGridConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Model rank j's corner rows of the hash grid, rebased into its level
    block ``[(L/m)*T, F]``, and their weights: (``[n, L/m, 8]`` int32,
    ``[n, L/m, 3]``, keep ``[n]``)."""
    lp = levels_per_rank(config.n_levels, m)
    flat_idx, weights, keep = hash_grid_indices(x, config)
    sl = slice(j * lp, (j + 1) * lp)
    return flat_idx[:, sl] - j * lp * config.table_size, weights[:, sl], keep


def tp_hash_interp(table_local: torch.Tensor, idx_local: torch.Tensor,
                   w_local: torch.Tensor) -> torch.Tensor:
    """The features ``[n, (L/m)*F]`` of the local corner rows (the
    single-device ``_CornerSum``, on the level block)."""
    feats = _CornerSum.apply(table_local, idx_local, corner_weights(w_local))
    return feats.reshape(idx_local.shape[0], -1)


def tp_hash_encode_local(x: torch.Tensor, table_local: torch.Tensor, j: int,
                         m: int, config: HashGridConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model rank j's share of the hash encode (JAX
    ``_local_level_encode``, :40): (``[n, (L/m)*F]``, keep ``[n]``)."""
    idx, w, keep = tp_hash_indices(x, j, m, config)
    return tp_hash_interp(table_local, idx, w), keep


def tp_hash_encode(x: torch.Tensor, table_local: torch.Tensor,
                   config: HashGridConfig, mesh
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The level-sharded hash encode over ``mesh``'s model axis (JAX
    ``tp_hash_encode``, :72) -> (``[n, L*F]``, keep ``[n]``)."""
    feats, keep = tp_hash_encode_local(x, table_local, mesh.index(MODEL),
                                       mesh.size(MODEL), config)
    return gather_features(feats, mesh), keep


def block_tp_context(mesh):
    """Route the grid encodes through the level-sharded encode over
    ``mesh`` inside the block (JAX ``block_tp_context``, :244): the active
    mesh of ``collectives.mesh_context``, which a sharded step enters."""
    return mesh_context(mesh)


def current_block_tp() -> Optional[object]:
    """The active mesh where it has a model axis (the grid encodes go
    through this module), else None."""
    mesh = active_mesh()
    return mesh if mesh is not None and mesh.size(MODEL) > 1 else None
