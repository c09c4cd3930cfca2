"""The collectives of the multi-device paths, over ``torch.distributed``.

XLA inserts these for the JAX package (``parallel/shard.py`` and
``parallel/tp.py`` there leave them to the SPMD partitioner and to
``shard_map``); here they are explicit. NCCL moves them on the card, Gloo
on the CPU. No kernel of the port computes them.

Both gathers have the same backward, the local slice of the cotangent:
every rank of the gathering group computes the same function of the
gathered tensor (the one global loss of the step, the MLP over all levels'
features), so the cotangents are identical across the group and each
rank's share is its own slice. A reduce-scatter there would make the
gradient group-size times too large.

``mesh_context`` makes a mesh the active one while a sharded step runs
(``parallel/shard.py::make_sharded_train_step``), and ``active_mesh``
reads it: the quantizers' calibration reduces its ranges over its data
axis, as the JAX global-view step reduces them over the global batch, and
``models/field.py::encode_position`` routes the grid encodes through the
level-sharded encode (``parallel/tp.py``) when it has a model axis.
"""

from __future__ import annotations

import contextlib
import torch
import torch.distributed as dist

DATA, MODEL = "data", "model"


class _GatherSlice(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``; backward: the local slice."""

    @staticmethod
    def forward(ctx, x, group, size, index, dim):
        ctx.dim, ctx.index, ctx.n = dim, index, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None, \
            None


def gather_axis(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """``x`` of every rank of ``mesh``'s ``axis`` concatenated along ``dim``
    in rank order (differentiable: the backward is the local slice). Where
    the mesh has no process group (one process, no ``torch.distributed``)
    this is ``x``."""
    group = None if mesh is None else mesh.group(axis)
    if group is None:
        return x
    return _GatherSlice.apply(x, group, mesh.size(axis), mesh.index(axis), dim)


def gather_rays(x: torch.Tensor, mesh) -> torch.Tensor:
    """The per-ray ``[n, ...]`` tensors of every data rank, ``[D*n, ...]``:
    the global batch, in data-rank order."""
    return gather_axis(x, mesh, DATA, 0)


def gather_features(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ``[n, (L/m)*F]`` level features of every model rank,
    ``[n, L*F]`` (model rank j holds levels ``[j*L/m, (j+1)*L/m)``)."""
    return gather_axis(x, mesh, MODEL, 1)


def all_reduce_(t: torch.Tensor, mesh, axis: str,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over ``mesh``'s ``axis`` (no gradient); ``t``
    where the mesh has no process group."""
    group = None if mesh is None else mesh.group(axis)
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


class _ModelSum(torch.autograd.Function):
    """Sum over the model group; backward: the cotangent itself."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def model_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """A table term of this rank's levels summed over the model axis: the
    value is the whole table's (the same on every model rank), the
    gradient reaches each rank's own levels once."""
    group = None if mesh is None else mesh.group(MODEL)
    if group is None:
        return x
    return _ModelSum.apply(x, group)


def gather_levels(t: torch.Tensor, mesh) -> torch.Tensor:
    """A per-level tensor of this rank's levels, ``[L/m, ...]``, gathered
    into all L levels (no gradient; a bool one travels as uint8)."""
    if t.dtype == torch.bool:
        return gather_levels(t.to(torch.uint8), mesh).to(torch.bool)
    return gather_axis(t.detach(), mesh, MODEL, 0)


_MESH = None


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the active mesh inside the block (None: no mesh, the
    single-device step)."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


def active_mesh():
    """The mesh of the sharded step that is running, or None."""
    return _MESH


def data_reduce_(t: torch.Tensor, op) -> torch.Tensor:
    """``t`` reduced in place over the active mesh's data axis (the global
    batch's min, max or sum of a per-rank statistic); ``t`` outside a
    sharded step."""
    return all_reduce_(t, _MESH, DATA, op)
