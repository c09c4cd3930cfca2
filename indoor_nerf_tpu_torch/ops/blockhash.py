"""Block-hash grid encoder (ops/blockhash.py of the JAX package).

The table is ``[L * R, F * lpf]``: one row holds a halo'd ``side^3``-vertex
tile of F features, so one (point, level) reads ONE row. Interpolation is
the tent-product contraction of that row (``ops/tent_contract.py``), and
the table gradient is the tent-weighted scatter-add of the output
cotangent (``ops/table_scatter.py``); on the card both run hand-written
CUDA kernels. ``block_tv_loss`` is the table's TV regularizer.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch.profiler import record_function

from indoor_nerf_tpu_torch.ops.encoding import level_resolutions
from indoor_nerf_tpu_torch.ops.table_scatter import table_scatter
from indoor_nerf_tpu_torch.ops.tent_contract import lanes_per_feature, tent_contract

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

    def __post_init__(self):
        if self.gather_dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(
                f"gather_dtype {self.gather_dtype!r}: the int8 gather comes "
                "with ROADMAP.md Queue 1 item 5 (training extensions)")
        if self.scatter_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"scatter_dtype {self.scatter_dtype!r}")

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


def _tile_coords(x: torch.Tensor, config: BlockHashConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-(point, level) table row + in-tile position.

    Returns (flat_row ``[N*L]`` int32, p ``[N*L, 3]`` f32, keep_mask ``[N]``).
    Block faces are C0 seams, so one ulp in ``rel`` can change a row: the
    op order below is the JAX one, in f32, and the tests hold it exact."""
    n = x.shape[0]
    L = config.n_levels
    R = config.rows_per_level
    dev = x.device
    box_min = torch.tensor(config.bbox_min, dtype=torch.float32, device=dev)
    box_max = torch.tensor(config.bbox_max, dtype=torch.float32, device=dev)
    res = torch.from_numpy(level_resolutions(config)).to(dev)  # [L]

    keep_mask = torch.all((x >= box_min) & (x <= box_max), dim=-1)
    xc = torch.minimum(torch.maximum(x, box_min), box_max)

    grid_size = (box_max - box_min)[None, :] / res[:, None]  # [L, 3]
    rel = (xc[:, None, :] - box_min) / grid_size[None, :, :]  # [N, L, 3]
    bl = torch.floor(rel).to(torch.int32)
    w = rel - bl.to(torch.float32)

    B = config.block_size
    stagger = torch.from_numpy(_stagger(L, B)).to(dev)  # [L, 3]
    v0 = bl + stagger[None, :, :]
    block = torch.div(v0, B, rounding_mode="floor")
    local0 = v0 - block * B

    level_ids = torch.arange(L, dtype=torch.int64, device=dev)
    row = _block_row_hash(block, level_ids[None, :], config.log2_rows)
    flat_row = (level_ids[None, :] * R + row).reshape(-1).to(torch.int32)
    p = (local0.to(torch.float32) + w).reshape(n * L, 3)
    return flat_row, p, keep_mask


def gather_table(table: torch.Tensor, config: BlockHashConfig) -> torch.Tensor:
    """The table in ``gather_dtype`` — what the row gather reads.

    The f32 master cast to bf16 for ``gather_dtype="bfloat16"`` (the JAX
    ``_gather_rows`` bf16 path, :355-361); a table already in the gather
    dtype is returned as is, so a server casts once per loaded params."""
    want = torch.bfloat16 if config.gather_dtype == "bfloat16" else torch.float32
    if table.dtype == want:
        return table
    if table.dtype != torch.float32:
        raise TypeError(f"table is {table.dtype}; the master table is "
                        f"float32 and the gather reads {want}")
    return table.to(want)


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


def block_hash_encode(x: torch.Tensor, table: torch.Tensor,
                      config: BlockHashConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode ``[N, 3]`` points -> (features ``[N, L*F]`` f32, keep_mask ``[N]``).

    ``table`` is the f32 master (its gradient is f32, of the master's
    shape) or its cached ``gather_table`` copy (no gradient). The gradient
    w.r.t. ``x`` is None. The JAX package gives the same zero ``dx`` at
    ``scatter_dtype`` bfloat16, but a nonzero one through XLA autodiff at
    float32, so a float32 encode refuses an ``x`` that requires grad."""
    grad_on = torch.is_grad_enabled()
    if grad_on and table.requires_grad and table.dtype != torch.float32:
        raise TypeError(f"a trainable table must be the float32 master, got "
                        f"{table.dtype}")
    if grad_on and x.requires_grad and config.scatter_dtype == "float32":
        raise NotImplementedError(
            "the gradient w.r.t. the encoded points: the port's encode gives "
            "none (ROADMAP.md Queue 3), while the JAX float32 encode "
            "differentiates through the tent weights")
    n = x.shape[0]
    flat_row, p, keep_mask = _tile_coords(x.detach(), config)
    out = _Encode.apply(table, flat_row, p, config)
    return out.reshape(n, config.out_dim), keep_mask


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
