"""The mesh, the sharded train state and the sharded step (``parallel/
shard.py`` of the JAX package).

A ``Mesh`` lays the ranks of ``torch.distributed`` out on named axes,
``data`` and ``model``, row-major as the JAX mesh reshapes its device list,
and holds one process group per axis: the ranks that share every other
coordinate. The port runs one process per card, so a mesh of N ranks is N
processes (``--multihost``); the JAX package can also put a mesh of several
devices in one process.

The state is replicated on every rank, except the grid's table, its RAdam
moments and its EMA copy, which a model axis shards by level block (rank j
of the model axis holds levels ``[j*L/m, (j+1)*L/m)``, contiguous rows of
the level-major table), as JAX ``state_shardings`` does.

``make_sharded_train_step`` runs ``train/step.py::train_step`` with the
batch sharded over the data axis: each data rank renders its rays, the
per-ray outputs the losses read are gathered, every rank computes the one
loss of the global batch, and the gradients are summed over the data axis
before the update. So a run on N ranks is the single-device step on the
concatenated batch, as the JAX global-view step is.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from indoor_nerf_tpu_torch.parallel.collectives import (
    DATA,
    MODEL,
    gather_axis,
    mesh_context,
)

AXES = (DATA, MODEL)


@dataclasses.dataclass
class Mesh:
    """Named axes over the ranks of ``torch.distributed``.

    ``groups`` holds, per axis, the process group of this rank's line
    along it (None without ``torch.distributed``: one process, where every
    collective is the identity); ``world_group`` spans every rank."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    coords: Tuple[int, ...]
    groups: Dict[str, Any]
    world_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def world_size(self) -> int:
        return int(np.prod(self.axis_sizes))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return dict(zip(self.axis_names, self.coords)).get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def parse_mesh_shape(spec: Optional[str], world: int
                     ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """``--mesh_shape`` (``data:4,model:2``) as (names, sizes), as JAX
    trainer.py:417-431 parses it; an axis without a size takes the ranks
    the others leave. None: every rank on the data axis."""
    if not spec:
        return (DATA,), (world,)
    names, sizes = [], []
    for part in spec.split(","):
        name, _, size = part.partition(":")
        names.append(name.strip())
        sizes.append(int(size) if size.strip() else None)
    known = int(np.prod([s for s in sizes if s is not None]))
    rest = world // known if known and world % known == 0 else 0
    return tuple(names), tuple(rest if s is None else s for s in sizes)


def make_mesh(axis_names: Tuple[str, ...] = (DATA,),
              axis_sizes: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh of this process over ``torch.distributed``'s ranks.
    Default: every rank on one ``data`` axis. Without an initialised
    process group the world is this one process and the mesh has no
    groups; with one (of any size, one included) each axis gets its
    process groups, which every rank creates in the same order."""
    distributed = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    rank = dist.get_rank() if distributed else 0
    if axis_sizes is None:
        axis_sizes = (world,) + (1,) * (len(axis_names) - 1)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    for name in axis_names:
        if name not in AXES:
            raise ValueError(f"mesh axis {name!r}: the port's axes are "
                             f"{AXES}")
    if len(set(axis_names)) != len(axis_names) \
            or len(axis_names) != len(axis_sizes):
        raise ValueError(f"mesh axes {axis_names} of sizes {axis_sizes}")
    n = int(np.prod(axis_sizes))
    if n != world:
        if not distributed:
            raise ValueError(
                f"a mesh of {n} ranks ({dict(zip(axis_names, axis_sizes))}) "
                "needs that many processes started with --multihost: the "
                "port runs one process per card")
        raise ValueError(f"mesh {dict(zip(axis_names, axis_sizes))} holds "
                         f"{n} ranks; the world has {world}")
    coords = tuple(int(c) for c in np.unravel_index(rank, axis_sizes))
    groups: Dict[str, Any] = {}
    if distributed:
        ids = np.arange(world).reshape(axis_sizes)
        for a, name in enumerate(axis_names):
            lines = np.moveaxis(ids, a, -1).reshape(-1, axis_sizes[a])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[name] = g
    return Mesh(tuple(axis_names), axis_sizes, rank, coords, groups,
                dist.group.WORLD if distributed else None)


def _grid(field_config):
    if field_config.i_embed == 3:
        return field_config.block_grid
    if field_config.i_embed == 1:
        return field_config.grid
    return None


def check_mesh(mesh: Mesh, field_config) -> None:
    """Refuse what the sharded step cannot run: a model axis that does not
    divide the grid's levels, and the ray-structured encodes under a model
    axis (JAX parallel/tp.py:190)."""
    m = mesh.size(MODEL)
    grid = _grid(field_config)
    if m == 1 or grid is None:
        return
    if grid.n_levels % m != 0:
        raise ValueError(f"the model axis of size {m} must divide the grid's "
                         f"{grid.n_levels} levels")
    if field_config.i_embed == 3 and (grid.ray_strides is not None
                                      or grid.ray_groups is not None):
        raise NotImplementedError(
            "--ray_strides/--ray_groups are not supported under tensor "
            "parallelism (a model axis); train it with a data axis only")


def level_rows(mesh: Mesh, n_rows: int) -> slice:
    """The rows of the level-major table that this rank's model index
    holds: the j-th of m equal blocks."""
    m, j = mesh.size(MODEL), mesh.index(MODEL)
    per = n_rows // m
    return slice(j * per, (j + 1) * per)


def _sharded_tables(state: Dict[str, Any]):
    """(container, key) of every table leaf the model axis shards: the
    params' table, its RAdam moments and its EMA copy."""
    if "table" not in state["params"]:
        return []
    out = [(state["params"], "table"), (state["opt"]["mu"], "table"),
           (state["opt"]["nu"], "table")]
    if state.get("ema") is not None:
        out.append((state["ema"], "table"))
    return out


def shard_state(state: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The full (replicated) train state with the table leaves cut to this
    rank's level block, in place; unchanged without a model axis."""
    if mesh.size(MODEL) == 1:
        return state
    for holder, key in _sharded_tables(state):
        t = holder[key]
        local = t.detach()[level_rows(mesh, t.shape[0])].clone()
        holder[key] = local.requires_grad_(t.requires_grad)
    return state


def gather_state(state: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """A copy of the state with the table leaves gathered over the model
    axis (every rank must call it): the single-device state, as rank 0
    saves it. Without a model axis, ``state`` itself."""
    if mesh.size(MODEL) == 1 or "table" not in state["params"]:
        return state
    out = dict(state, params=dict(state["params"]),
               opt=dict(state["opt"], mu=dict(state["opt"]["mu"]),
                        nu=dict(state["opt"]["nu"])))
    if state.get("ema") is not None:
        out["ema"] = dict(state["ema"])
    for holder, key in _sharded_tables(out):
        holder[key] = gather_axis(holder[key].detach(), mesh, MODEL, 0)
    return out


def make_sharded_train_step(config, mesh: Mesh):
    """``train_step`` over ``mesh`` (JAX :71-128): ``step(state, batch,
    generator=None, draws=None, prior_weights=None) -> (state, metrics)``
    with the rest of ``train_step``'s signature. ``batch`` holds this data
    rank's rays (``N / D`` of them, and ``P / D`` patches); the draws, made
    from the replicated generator or given, are the global batch's, and
    each rank takes its slice. ``state`` is ``shard_state``'s. With a model
    axis and a grid field, the encodes go through the level-sharded encode
    (``parallel/tp.py``; ``mesh_context`` makes the mesh the active one)."""
    from indoor_nerf_tpu_torch.train.step import train_step

    check_mesh(mesh, config.render.field)

    def step(state, batch, generator=None, draws=None, prior_weights=None):
        with mesh_context(mesh):
            return train_step(state, batch, config, generator, draws,
                              prior_weights, mesh=mesh)

    return step
