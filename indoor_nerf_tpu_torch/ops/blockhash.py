"""Block-hash grid encoder (ops/blockhash.py of the JAX package).

The table is ``[L * R, F * lpf]``: one row holds a halo'd ``side^3``-vertex
tile of F features, so one (point, level) reads ONE row. Interpolation is
the tent-product contraction of that row (``ops/tent_contract.py``), and
the table gradient is the tent-weighted scatter-add of the output
cotangent (``ops/table_scatter.py``); on the card both run hand-written
CUDA kernels. The master table keeps the JAX layout (feature planes); the
contraction reads a vertex-major packed copy of it (``gather_table``), and
the scatter returns its gradient in the master's layout.
``block_tv_loss`` is the table's TV regularizer.

A second route, ``BlockHashConfig.tile_interp`` (the trainer's
``--use_pallas``), runs the encode as the JAX package does under
``USE_TILE_INTERP_KERNEL``: a plain row gather under autograd, then
``ops/tile_interp.py`` over the gathered rows. It applies at ``block_size
4`` with a float32 scatter only, and it alone differentiates through the
tent weights to the points.

Two ray-structured encodes take ``[Rn, S, 3]`` samples sorted along each
ray: ``block_hash_encode_grouped`` (``ray_groups``: the exact features, and
a backward that sums each group of G consecutive samples' cotangent into
one row of the group's anchor tile, ``grouped_scatter`` over
``ops/group_scatter.py``) and
``block_hash_encode_strided`` (``ray_strides``: coarse levels encoded at
knot samples and lerped along the ray).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from indoor_nerf_tpu_torch.ops.constants import device_constant
from indoor_nerf_tpu_torch.ops.encoding import level_resolutions
from indoor_nerf_tpu_torch.ops.group_scatter import (
    group_scatter_anchored,
    group_scatter_plain,
)
from indoor_nerf_tpu_torch.ops.table_scatter import table_scatter
from indoor_nerf_tpu_torch.ops.tent_contract import (
    lanes_per_feature,
    pack_rows,
    tent_contract,
)
from indoor_nerf_tpu_torch.ops.tile_interp import tile_interp

_BLOCK_PRIMES = (2654435761, 805459861, 3674653429, 2097192037)
_MASK32 = 0xFFFFFFFF


def _stagger(n_levels: int, block: int) -> np.ndarray:
    """Per-level block-partition stagger (vertex units); decorrelates the
    block faces across levels so single-level C0 seams never align."""
    return np.array(
        [[(3 * l) % block, (2 * l + 1) % block, (l + 2) % block]
         for l in range(n_levels)], dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class BlockHashConfig:
    """Static geometry of the block-hash grid (same fields as the JAX one).

    The port runs ``gather_dtype`` float32 and bfloat16. ``scatter_dtype``
    is the dtype the backward rounds each cotangent entry to before the f32
    sum (bfloat16 for the flagship)."""

    bbox_min: Tuple[float, float, float]
    bbox_max: Tuple[float, float, float]
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_rows: int = 12
    base_resolution: int = 16
    finest_resolution: int = 512
    gather_dtype: str = "float32"
    scatter_dtype: str = "float32"
    block_size: int = 4
    # Per-level sample strides (``block_hash_encode_strided``) or backward
    # group sizes (``block_hash_encode_grouped``), coarsest level first; at
    # most one of the two, each None or ``n_levels`` positive ints.
    ray_strides: Optional[Tuple[int, ...]] = None
    ray_groups: Optional[Tuple[int, ...]] = None
    # Ask for the tile-interp route (the JAX module global
    # ``USE_TILE_INTERP_KERNEL``, set by ``--use_pallas``). It is taken
    # where JAX takes it (``uses_tile_interp``) and ignored elsewhere.
    tile_interp: bool = False

    def __post_init__(self):
        if self.gather_dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(
                f"gather_dtype {self.gather_dtype!r}: the int8 gather comes "
                "with ROADMAP.md Queue 1 item 5b (A-CAQ and the int8 gather)")
        if self.scatter_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"scatter_dtype {self.scatter_dtype!r}")
        if self.ray_strides is not None and self.ray_groups is not None:
            raise ValueError("ray_strides and ray_groups are mutually exclusive")
        for name in ("ray_strides", "ray_groups"):
            v = getattr(self, name)
            if v is not None and (len(v) != self.n_levels
                                  or any(int(k) < 1 for k in v)):
                raise ValueError(f"{name} must hold {self.n_levels} positive "
                                 f"ints (one per level), got {v}")
        if self.uses_tile_interp and self.n_features_per_level != 2:
            raise ValueError(
                "the tile-interp route (--use_pallas at block_size 4, f32 "
                "scatter) reads exactly two 128-lane feature planes per row; "
                f"n_features_per_level is {self.n_features_per_level} (the "
                "JAX package fails there at a reshape)")

    @property
    def uses_tile_interp(self) -> bool:
        """Whether the encode takes the tile-interp route: asked for, at
        ``block_size 4`` and a float32 scatter (JAX ops/blockhash.py:588-595
        and :413; the int8 gather, which also bypasses it, is not ported)."""
        return (self.tile_interp and self.block_size == 4
                and self.scatter_dtype == "float32")

    @property
    def rows_per_level(self) -> int:
        return 1 << self.log2_rows

    @property
    def side(self) -> int:
        return self.block_size + 1

    @property
    def lanes_per_feature(self) -> int:
        return lanes_per_feature(self.side)

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def torch_scatter_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.scatter_dtype == "bfloat16" else torch.float32


def init_block_table(generator: torch.Generator, config: BlockHashConfig,
                     device=None) -> torch.Tensor:
    """Fused table ``[L * R, F * lanes_per_feature]`` ~ U(-1e-4, 1e-4).

    ``generator`` must live on ``device`` (a CPU generator for CPU tables)."""
    shape = (config.n_levels * config.rows_per_level,
             config.n_features_per_level * config.lanes_per_feature)
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    return u * 2e-4 - 1e-4


def _block_row_hash(block: torch.Tensor, level: torch.Tensor,
                    log2_rows: int) -> torch.Tensor:
    """XOR-of-primes hash of (block coords, level) -> row in [0, 2^log2_rows).

    The JAX version multiplies as uint32 with wraparound; here each product
    is taken in int64 and masked to 32 bits, which is the same. Block
    coordinates are never negative (the caller clamps to the bbox)."""
    b = block.to(torch.int64)
    out = (b[..., 0] * _BLOCK_PRIMES[0]) & _MASK32
    out = out ^ ((b[..., 1] * _BLOCK_PRIMES[1]) & _MASK32)
    out = out ^ ((b[..., 2] * _BLOCK_PRIMES[2]) & _MASK32)
    out = out ^ ((level.to(torch.int64) * _BLOCK_PRIMES[3]) & _MASK32)
    return out & ((1 << log2_rows) - 1)


def _keep_mask(x: torch.Tensor, config: BlockHashConfig) -> torch.Tensor:
    """Points inside the bbox (faces included) ``[...]`` bool."""
    box_min = device_constant(config.bbox_min, torch.float32, x.device)
    box_max = device_constant(config.bbox_max, torch.float32, x.device)
    return torch.all((x >= box_min) & (x <= box_max), dim=-1)


def _levels(config: BlockHashConfig,
            levels: Optional[Sequence[int]]) -> np.ndarray:
    return (np.arange(config.n_levels) if levels is None
            else np.asarray(levels, np.int64))


def _vertex_coords(x: torch.Tensor, config: BlockHashConfig, lv: np.ndarray
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Levels ``lv`` of the staggered vertex lattice at ``[N, 3]`` points.

    Returns (v0 ``[N, L, 3]`` int32 bottom-left vertex, w ``[N, L, 3]`` f32
    trilinear weights, level_ids ``[L]`` int64, keep_mask ``[N]``). Block
    faces are C0 seams, so one ulp in ``rel`` can change a row: the op
    order below is the JAX one, in f32, and the tests hold it exact."""
    dev = x.device
    box_min = device_constant(config.bbox_min, torch.float32, dev)
    box_max = device_constant(config.bbox_max, torch.float32, dev)
    res = device_constant(level_resolutions(config)[lv], torch.float32, dev)
    keep_mask = torch.all((x >= box_min) & (x <= box_max), dim=-1)
    xc = torch.minimum(torch.maximum(x, box_min), box_max)
    grid_size = (box_max - box_min)[None, :] / res[:, None]  # [L, 3]
    rel = (xc[:, None, :] - box_min) / grid_size[None, :, :]  # [N, L, 3]
    bl = torch.floor(rel).to(torch.int32)
    w = rel - bl.to(torch.float32)
    stagger = device_constant(
        _stagger(config.n_levels, config.block_size)[lv], torch.int32, dev)
    level_ids = device_constant(lv, torch.int64, dev)
    return bl + stagger[None, :, :], w, level_ids, keep_mask


def _rows_in_tiles(vertex: torch.Tensor, v0: torch.Tensor, w: torch.Tensor,
                   level_ids: torch.Tensor, config: BlockHashConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global table row of the partition block holding ``vertex`` and
    the position of (``v0`` + ``w``) in that block's tile, both ``[..., L]``
    (the level axis last but one for ``v0``, ``w`` and ``vertex``)."""
    B = config.block_size
    block = torch.div(vertex, B, rounding_mode="floor")
    row = _block_row_hash(block, level_ids, config.log2_rows)
    row = (level_ids * config.rows_per_level + row).to(torch.int32)
    p = (v0 - block * B).to(torch.float32) + w
    return row, p


def _tile_coords(x: torch.Tensor, config: BlockHashConfig,
                 levels: Optional[Sequence[int]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-(point, level) table row + in-tile position.

    Returns (flat_row ``[N*L]`` int32, p ``[N*L, 3]`` f32, keep_mask ``[N]``).
    ``levels`` restricts the encode to a subset of the grid's levels (L of
    them); rows stay global (level id * R + hash), so a subset encode
    addresses the same table (JAX ``_tile_coords``, :296-337)."""
    v0, w, level_ids, keep_mask = _vertex_coords(x, config,
                                                 _levels(config, levels))
    row, p = _rows_in_tiles(v0, v0, w, level_ids, config)
    return row.reshape(-1), p.reshape(-1, 3), keep_mask


def _level_runs(per_level: Sequence[int]
                ) -> Tuple[Tuple[int, Tuple[int, ...]], ...]:
    """Contiguous runs of levels of equal value, ``((v, (levels...)), ...)``
    in level order."""
    runs = []
    for l, v in enumerate(per_level):
        if runs and runs[-1][0] == v:
            runs[-1][1].append(l)
        else:
            runs.append([int(v), [l]])
    return tuple((v, tuple(lv)) for v, lv in runs)


def _grouped_classes(config: BlockHashConfig, S: int
                     ) -> Tuple[Tuple[int, Tuple[int, ...]], ...]:
    """Contiguous runs of levels of equal backward group size,
    ``((G, (levels...)), ...)`` in level order. A G that does not divide
    the sample count S demotes to 1 (JAX ``_grouped_classes``, :777-794)."""
    return _level_runs([int(g) if (g > 1 and S % int(g) == 0) else 1
                        for g in config.ray_groups])


@functools.lru_cache(maxsize=64)
def _anchor_samples(groups: Tuple[int, ...], S: int,
                    device: torch.device) -> torch.Tensor:
    """``[S, L]`` int64: the anchor sample (member ``G // 2``) of sample s's
    group at level l. Cached per device, so a training step copies nothing
    to the card for it."""
    G = np.asarray(groups, np.int64)
    s = np.arange(S, dtype=np.int64)[:, None]
    return torch.from_numpy((s // G) * G + G // 2).to(device)


def _grouped_coords(v0: torch.Tensor, w: torch.Tensor, level_ids: torch.Tensor,
                    config: BlockHashConfig, groups: Tuple[int, ...]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every (sample, level)'s group anchor row and its position in the
    anchor tile, over all levels in one pass (JAX ``_grouped_coords``,
    :730-774, which takes one class of levels at a time).

    ``v0``, ``w`` ``[Rn, S, L, 3]`` and ``level_ids`` are the lattice
    coordinates (``_vertex_coords``) of ray-structured samples; ``groups``
    holds each level's group size G, which divides S. The group of sample
    s at level l holds samples ``(s // G) * G ...`` + G - 1; its anchor is
    member ``G // 2``'s vertex, the anchor tile its partition block.
    Returns (row ``[Rn, S, L]`` int32 global row of the anchor tile, the
    same for every member, p ``[Rn, S, L, 3]`` f32 = the member's vertex
    minus the anchor block's origin, plus its weights, clipped to the tent
    support ``[0, B]``). At G = 1 this is ``_tile_coords`` bit for bit (the
    clip changes nothing)."""
    Rn, S, L, _ = v0.shape
    idx = _anchor_samples(groups, S, v0.device)
    anchor = torch.gather(v0, 1, idx[None, :, :, None].expand(Rn, S, L, 3))
    row, p = _rows_in_tiles(anchor, v0, w, level_ids, config)
    return row, torch.clamp(p, 0.0, float(config.block_size))


def grouped_scatter_plain(g: torch.Tensor, v0: torch.Tensor, w: torch.Tensor,
                          level_ids: torch.Tensor, config: BlockHashConfig,
                          groups: Tuple[int, ...], n_rows: int) -> torch.Tensor:
    """The grouped encode's table gradient, plain version: the anchor
    coordinates (``_grouped_coords``), then ``group_scatter_plain``."""
    row, p = _grouped_coords(v0, w, level_ids, config, groups)
    return group_scatter_plain(g, row, p, groups, n_rows, config.side,
                               config.lanes_per_feature,
                               config.torch_scatter_dtype)


def grouped_scatter(g: torch.Tensor, v0: torch.Tensor, w: torch.Tensor,
                    level_ids: torch.Tensor, config: BlockHashConfig,
                    groups: Tuple[int, ...], n_rows: int) -> torch.Tensor:
    """The grouped encode's table gradient ``[n_rows, F*lpf]`` f32 from the
    cotangent ``g`` ``[Rn, S, L*F]`` and the forward's lattice coordinates
    (``v0``, ``w`` ``[Rn, S, L, 3]``, ``level_ids``). CPU tensors: the plain
    version. CUDA tensors: ``group_scatter_anchored``, whose kernel does the
    anchor math of ``_grouped_coords`` itself (no row or position tensor
    reaches device memory), or it raises."""
    if g.device.type == "cpu":
        return grouped_scatter_plain(g, v0, w, level_ids, config, groups,
                                     n_rows)
    return group_scatter_anchored(
        g, v0, w, level_ids, groups, n_rows, config.side,
        config.lanes_per_feature, config.torch_scatter_dtype,
        config.log2_rows, _BLOCK_PRIMES)


def _gather_dtype(config: BlockHashConfig) -> torch.dtype:
    return torch.bfloat16 if config.gather_dtype == "bfloat16" else torch.float32


def gather_table(table: torch.Tensor, config: BlockHashConfig) -> torch.Tensor:
    """The table as the row gather reads it: the packed copy
    ``[L*R, lpf, F]`` (vertex major, ``ops/tent_contract.py::pack_rows``) in
    ``gather_dtype``.

    The f32 master ``[L*R, F*lpf]`` is transposed and cast in one pass (the
    cast is the JAX ``_gather_rows`` bf16 path, :355-361). The 3-D shape
    marks a copy that is already packed: it is returned as is, so a server
    packs once per loaded params while a training step packs once per
    encode call."""
    want = _gather_dtype(config)
    if table.dim() == 3:
        if table.dtype != want:
            raise TypeError(f"the packed table is {table.dtype}; the gather "
                            f"reads {want}")
        return table
    if table.dtype != torch.float32:
        raise TypeError(f"table is {table.dtype}; the master table is "
                        f"float32 and the gather reads {want}")
    return pack_rows(table, config.n_features_per_level, want)


def _gather_interp(table: torch.Tensor, flat_row: torch.Tensor,
                   p: torch.Tensor, config: BlockHashConfig) -> torch.Tensor:
    """ONE row gather per (point, level) + tent-product interpolation."""
    return tent_contract(gather_table(table, config), flat_row, p.contiguous(),
                         config.side, config.n_features_per_level)


class _Encode(torch.autograd.Function):
    """The encode's row gather + tent contraction with its fused backward
    (the JAX ``_encode_fused`` custom VJP, ops/blockhash.py:442-567).

    Forward: ``tent_contract`` (rows in ``gather_dtype``, f32 sums).
    Backward: ``table_scatter`` — each cotangent entry rounded to
    ``scatter_dtype`` and summed in f32 into an f32 gradient of the
    master's shape. No gradient flows to ``flat_row`` or ``p``: the encode
    gives none w.r.t. the points, as the JAX fused VJP (:562-564)."""

    @staticmethod
    def forward(ctx, table, flat_row, p, config):
        ctx.save_for_backward(flat_row, p)
        ctx.config = config
        ctx.n_rows = table.shape[0]
        return _gather_interp(table, flat_row, p, config)

    @staticmethod
    def backward(ctx, g):
        flat_row, p = ctx.saved_tensors
        c = ctx.config
        with record_function("encode_bwd"):
            grad = table_scatter(g.contiguous(), p, flat_row, ctx.n_rows,
                                 c.side, c.lanes_per_feature,
                                 c.torch_scatter_dtype)
        return grad, None, None, None


def _check_trainable(table: torch.Tensor) -> None:
    if torch.is_grad_enabled() and table.requires_grad \
            and table.dtype != torch.float32:
        raise TypeError(f"a trainable table must be the float32 master, got "
                        f"{table.dtype}")


def block_hash_encode(x: torch.Tensor, table: torch.Tensor,
                      config: BlockHashConfig,
                      levels: Optional[Sequence[int]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode ``[N, 3]`` points -> (features ``[N, L*F]`` f32, keep_mask ``[N]``).

    ``levels`` restricts the encode to a subset of the grid's levels (L of
    them, in the order given); its gradient still lands in the full table.
    ``table`` is the f32 master (its gradient is f32, of the master's
    shape) or its cached packed ``gather_table`` copy (no gradient). The
    gradient w.r.t. ``x`` is None. The JAX package gives the same zero ``dx`` at
    ``scatter_dtype`` bfloat16, but a nonzero one through XLA autodiff at
    float32, so a float32 encode refuses an ``x`` that requires grad.

    On the tile-interp route (``config.uses_tile_interp``) the encode is a
    row gather under autograd and ``tile_interp`` over the rows: the table
    gradient is the gather's own f32 ``index_add_`` of ``d rows``, and the
    points get the JAX ``dx`` through the tent weights."""
    _check_trainable(table)
    if config.uses_tile_interp:
        return _encode_tile_interp(x, table, config, levels)
    if torch.is_grad_enabled() and x.requires_grad \
            and config.scatter_dtype == "float32":
        raise NotImplementedError(
            "the gradient w.r.t. the encoded points: the port's encode gives "
            "none (ROADMAP.md Queue 3), while the JAX float32 encode "
            "differentiates through the tent weights")
    lv = _levels(config, levels)
    flat_row, p, keep_mask = _tile_coords(x.detach(), config, lv)
    out = _Encode.apply(table, flat_row, p, config)
    return out.reshape(x.shape[0], len(lv) * config.n_features_per_level), \
        keep_mask


def _encode_tile_interp(x: torch.Tensor, table: torch.Tensor,
                        config: BlockHashConfig,
                        levels: Optional[Sequence[int]]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encode as the JAX package runs it under ``USE_TILE_INTERP_KERNEL``
    (ops/blockhash.py:594-595, :411-416): ``_tile_coords`` -> a row gather
    -> ``tile_interp``, all under autograd.

    The gathered rows ``[N*L, 256]`` f32 reach device memory here (1 KiB
    per (point, level)), which the ``tent_contract`` route never holds. The
    gather's backward (``index_add_`` of ``d rows`` in f32) is PyTorch's, as
    the JAX scatter-add is XLA's and outside the Pallas kernel; its atomics
    land in an order that changes from run to run. ``_tile_coords`` sees
    ``x`` itself, not ``x.detach()``: ``w = rel - floor(rel)`` carries the
    gradient on to the points."""
    if table.dim() != 2:
        raise ValueError("the tile-interp route gathers whole rows of the "
                         "master layout [L*R, F*lpf], got a packed table "
                         f"{tuple(table.shape)}")
    lv = _levels(config, levels)
    flat_row, p, keep_mask = _tile_coords(x, config, lv)
    # Its own cast: gather_table would pack, and this route reads planes.
    rows = table.to(_gather_dtype(config)).index_select(0, flat_row)
    if rows.dtype != torch.float32:
        rows = rows.to(torch.float32)
    out = tile_interp(rows, p.contiguous())
    return out.reshape(x.shape[0], len(lv) * config.n_features_per_level), \
        keep_mask


class _EncodeGrouped(torch.autograd.Function):
    """The exact encode forward with the group-merged backward (the JAX
    ``_encode_grouped_fused`` custom VJP, ops/blockhash.py:797-934).

    Forward: ``tent_contract`` over every (sample, level), the same
    features as ``block_hash_encode``. Backward: ``grouped_scatter`` — per
    level, each group of G consecutive samples adds the f32 sum of its
    members' cotangent entries, in the anchor tile's coordinates, rounded
    once to ``scatter_dtype``, to the anchor's row. The JAX backward
    recomputes the lattice coordinates from the points; here the forward
    keeps them (24 B per (sample, level), 24 MiB at the flagship), which
    saves the backward that work and its host-to-device copies of the
    level constants. No gradient flows to the points (JAX returns a zero
    ``dx``)."""

    @staticmethod
    def forward(ctx, table, v0, w, level_ids, config, groups):
        Rn, S, L, _ = v0.shape
        ctx.save_for_backward(v0, w, level_ids)
        ctx.config, ctx.groups, ctx.n_rows = config, groups, table.shape[0]
        flat_row, p = _rows_in_tiles(v0, v0, w, level_ids, config)
        out = _gather_interp(table, flat_row.reshape(-1), p.reshape(-1, 3),
                             config)
        return out.reshape(Rn, S, -1)

    @staticmethod
    def backward(ctx, g):
        v0, w, level_ids = ctx.saved_tensors
        with record_function("encode_bwd"):
            grad = grouped_scatter(g.contiguous(), v0, w, level_ids,
                                   ctx.config, ctx.groups, ctx.n_rows)
        return grad, None, None, None, None, None


def block_hash_encode_grouped(pts: torch.Tensor, table: torch.Tensor,
                              config: BlockHashConfig
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ray-structured encode ``[Rn, S, 3] -> ([Rn, S, L*F], keep [Rn, S])``
    honoring ``config.ray_groups`` (JAX ``block_hash_encode_grouped``).

    The features are always the exact per-sample encode; grouping changes
    only where the backward's gradient lands. A group's merged row equals
    the per-sample scatter while its samples share the anchor's partition
    block (the common case at coarse levels); otherwise the group's
    gradient lands in the anchor tile with edge-clamped tent weights. When
    every level's G is 1 (after ``_grouped_classes`` demotes the G that do
    not divide S) this is ``block_hash_encode``."""
    Rn, S, _ = pts.shape
    classes = _grouped_classes(config, S)
    if all(g == 1 for g, _ in classes):
        f, keep = block_hash_encode(pts.reshape(-1, 3), table, config)
        return f.reshape(Rn, S, -1), keep.reshape(Rn, S)
    _check_trainable(table)
    groups = tuple(g for g, lv in classes for _ in lv)
    v0, w, level_ids, keep = _vertex_coords(pts.detach().reshape(-1, 3),
                                            config, _levels(config, None))
    L = config.n_levels
    out = _EncodeGrouped.apply(table, v0.reshape(Rn, S, L, 3),
                               w.reshape(Rn, S, L, 3), level_ids, config,
                               groups)
    return out, keep.reshape(Rn, S)


def _at_knots(a: torch.Tensor, k: int) -> torch.Tensor:
    """``a`` ``[Rn, S, ...]`` at the knot samples of stride k: every k-th
    sample and the last (JAX ``_stride_knots``, :599-619)."""
    if (a.shape[1] - 1) % k == 0:
        return a[:, ::k]
    return torch.cat([a[:, ::k], a[:, -1:]], dim=1)


def block_hash_encode_strided(pts: torch.Tensor, table: torch.Tensor,
                              config: BlockHashConfig
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ray-structured encode ``[Rn, S, 3] -> ([Rn, S, L*F], keep [Rn, S])``
    honoring ``config.ray_strides`` (JAX ``block_hash_encode_strided``,
    :622-703). Samples must be sorted along each ray.

    Each run of consecutive levels of equal stride k is one subset encode:
    at every sample for k = 1; else at the knot samples (``_at_knots``)
    only, lerped back over the samples by arc length from the ray's first
    sample, as an f32 einsum. The lerp's transpose is autograd's, so its
    backward feeds the knot encode's ``table_scatter``."""
    Rn, S, _ = pts.shape
    t = torch.linalg.norm(pts - pts[:, :1, :], dim=-1)  # [Rn, S], monotone
    outs = []
    for k, lv in _level_runs(config.ray_strides):
        if k <= 1:
            f, _ = block_hash_encode(pts.reshape(-1, 3), table, config, lv)
            outs.append(f.reshape(Rn, S, -1))
            continue
        xk = _at_knots(pts, k)
        K = xk.shape[1]
        fk, _ = block_hash_encode(xk.reshape(-1, 3), table, config, lv)
        fk = fk.reshape(Rn, K, -1)
        if K == 1:
            outs.append(fk.expand(Rn, S, fk.shape[-1]))
            continue
        tk = _at_knots(t, k)  # [Rn, K]
        # Bracket per sample: the count of knots at or before it, in [1, K-1].
        inds = torch.sum((tk[:, None, :] <= t[:, :, None]).to(torch.int32), -1)
        j = torch.clamp(inds - 1, 0, K - 2)  # [Rn, S]
        iota = torch.arange(K, device=pts.device)
        oh_lo = (iota == j[..., None]).to(torch.float32)  # [Rn, S, K]
        oh_hi = (iota == (j + 1)[..., None]).to(torch.float32)
        t_lo = torch.sum(oh_lo * tk[:, None, :], -1)
        t_hi = torch.sum(oh_hi * tk[:, None, :], -1)
        w = torch.clamp((t - t_lo) / torch.clamp_min(t_hi - t_lo, 1e-10),
                        0.0, 1.0)
        Wr = oh_lo * (1.0 - w)[..., None] + oh_hi * w[..., None]
        outs.append(torch.einsum("rkf,rsk->rsf", fk, Wr))
    return torch.cat(outs, dim=-1), _keep_mask(pts, config)


def draw_tv_rows(generator: torch.Generator, config: BlockHashConfig,
                 rows_per_level: int = 256) -> torch.Tensor:
    """The TV loss's row draw (JAX :278-280): ``min(rows_per_level, R)``
    rows per level, uniform, as global row ids ``[L * m]`` int64."""
    L, R = config.n_levels, config.rows_per_level
    m = min(rows_per_level, R)
    dev = generator.device
    local = torch.randint(0, R, (L, m), generator=generator, device=dev)
    levels = torch.arange(L, dtype=torch.int64, device=dev)
    return (local + levels[:, None] * R).reshape(-1)


def block_tv_loss(table: torch.Tensor, config: BlockHashConfig,
                  rows_idx: torch.Tensor) -> torch.Tensor:
    """Total-variation regularizer of the block table (JAX :246-293).

    Squared differences between each live vertex and its +z/+y/+x tile
    neighbours (lanes l+1, l+side, l+side^2) over the rows ``rows_idx``
    (``draw_tv_rows``), divided by the rows drawn per level. Its gradient
    is plain autograd (``index_select`` -> ``index_add``), as the JAX one
    is XLA's."""
    L, F = config.n_levels, config.n_features_per_level
    side, lpf = config.side, config.lanes_per_feature
    m = rows_idx.shape[0] // L
    lane = torch.arange(lpf, device=table.device)
    lx, ly, lz = lane // (side * side), (lane // side) % side, lane % side
    live = lane < side ** 3
    rows = table.index_select(0, rows_idx)  # [L*m, F*lpf]
    x = rows.reshape(L * m * F, lpf)
    tv = 0.0
    for k, coord in ((1, lz), (side, ly), (side * side, lx)):
        mask = ((coord < side - 1) & live).to(torch.float32)
        tv = tv + torch.sum(mask * (torch.roll(x, -k, dims=1) - x) ** 2)
    return tv / m
