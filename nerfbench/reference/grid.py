"""The two grid encodes of the configurations, in plain PyTorch.

Block-hash grid: the scene box is cut into a vertex lattice per level
(resolutions from ``base_res`` to ``finest_res``, staggered per level);
the lattice is partitioned into blocks of ``block_size``^3 cells, and the
``side``^3 vertices of a block's tile (``side = block_size + 1``, the halo
included) are one row of the table ``[L * R, F * lanes]`` (feature planes,
``lanes`` >= side^3, the rest padding), addressed by an XOR-of-primes hash
of the block's coordinates and the level. A point's features at a level
are the trilinear (tent) interpolation of the 8 tile vertices around it.

Hash grid (Instant-NGP, arXiv:2201.05989, as HashNeRF-pytorch writes it):
each level's 8 voxel corners are hashed into that level's ``2^T`` rows
of ``[L * 2^T, F]`` and interpolated trilinearly.

Lattice coordinates are computed in float32 in one fixed order (the grid
size as ``(max - min) / res``, then a division by it): a point on a block
face or voxel face moves to the other side on one ulp.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nerfbench.reference.spec import Spec, level_resolutions

_BLOCK_PRIMES = (2654435761, 805459861, 3674653429, 2097192037)
_HASH_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF


def _box(spec: Spec, device):
    return (torch.tensor(spec.bbox_min, dtype=torch.float32, device=device),
            torch.tensor(spec.bbox_max, dtype=torch.float32, device=device))


def keep_mask(x: torch.Tensor, spec: Spec) -> torch.Tensor:
    lo, hi = _box(spec, x.device)
    return torch.all((x >= lo) & (x <= hi), dim=-1)


def _lattice(x: torch.Tensor, spec: Spec):
    """(floor ``[N, L, 3]`` float, fractional part ``[N, L, 3]``)."""
    lo, hi = _box(spec, x.device)
    res = torch.tensor(level_resolutions(spec.n_levels, spec.base_res,
                                         spec.finest_res), device=x.device)
    xc = torch.minimum(torch.maximum(x, lo), hi)
    grid_size = (hi - lo)[None, :] / res[:, None]
    rel = (xc[:, None, :] - lo) / grid_size[None, :, :]
    bl = torch.floor(rel)
    return bl, rel - bl


def _stagger(spec: Spec, device) -> torch.Tensor:
    B = spec.block_size
    return torch.tensor([[(3 * l) % B, (2 * l + 1) % B, (l + 2) % B]
                         for l in range(spec.n_levels)], dtype=torch.int64,
                        device=device)


def block_coords(x: torch.Tensor, spec: Spec
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (point, level)'s table row ``[N, L]`` int64 and its position in
    the row's tile ``[N, L, 3]`` float32 (in [0, block_size])."""
    bl, w = _lattice(x, spec)
    B = spec.block_size
    v0 = bl.to(torch.int64) + _stagger(spec, x.device)[None]
    block = torch.div(v0, B, rounding_mode="floor")
    level = torch.arange(spec.n_levels, dtype=torch.int64, device=x.device)
    h = (block[..., 0] * _BLOCK_PRIMES[0]) & _MASK32
    h = h ^ ((block[..., 1] * _BLOCK_PRIMES[1]) & _MASK32)
    h = h ^ ((block[..., 2] * _BLOCK_PRIMES[2]) & _MASK32)
    h = h ^ ((level * _BLOCK_PRIMES[3]) & _MASK32)[None, :]
    row = level[None, :] * spec.rows + (h & (spec.rows - 1))
    p = (v0 - block * B).to(torch.float32) + w
    return row, p


def tent_factors(p: torch.Tensor, spec: Spec):
    """The per-axis tent weights ``[M, lanes]`` of tile positions ``p``
    ``[M, 3]``: lane v is vertex (v // side^2, v // side % side, v % side);
    padding lanes weigh 0."""
    side, lanes = spec.side, spec.lanes
    v = torch.arange(lanes, device=p.device)
    lx = (v // (side * side)).to(torch.float32)
    ly = ((v // side) % side).to(torch.float32)
    lz = (v % side).to(torch.float32)
    return (torch.clamp_min(1.0 - torch.abs(lx[None] - p[:, 0:1]), 0.0),
            torch.clamp_min(1.0 - torch.abs(ly[None] - p[:, 1:2]), 0.0),
            torch.clamp_min(1.0 - torch.abs(lz[None] - p[:, 2:3]), 0.0))


def tent_weights(p: torch.Tensor, spec: Spec) -> torch.Tensor:
    """``[M, lanes]`` trilinear weights of tile positions ``p``."""
    tx, ty, tz = tent_factors(p, spec)
    return tx * ty * tz


class _BlockInterp(torch.autograd.Function):
    """Row gather + tent interpolation; the table gradient is the
    tent-weighted cotangent added into the rows (each entry rounded to
    bfloat16 first where the configuration's table IO is bf16). No
    gradient reaches the points."""

    @staticmethod
    def forward(ctx, table, row, p, spec):
        rows = table.index_select(0, row)
        if spec.gather_bf16:
            rows = rows.to(torch.bfloat16).to(torch.float32)
        w = tent_weights(p, spec)
        F, lanes = spec.n_features, spec.lanes
        out = (rows.view(-1, F, lanes) * w[:, None, :]).sum(-1)
        ctx.save_for_backward(row, p)
        ctx.spec, ctx.shape = spec, table.shape
        return out

    @staticmethod
    def backward(ctx, g):
        row, p = ctx.saved_tensors
        spec = ctx.spec
        # Each cotangent entry as ((g * tx) * ty) * tz, so that its bf16
        # rounding below lands where the configuration's scatter rounds.
        tx, ty, tz = (t[:, None, :] for t in tent_factors(p, spec))
        cot = (((g[:, :, None] * tx) * ty) * tz).reshape(g.shape[0], -1)
        if spec.scatter_bf16:
            cot = cot.to(torch.bfloat16).to(torch.float32)
        grad = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        grad.index_add_(0, row, cot)
        return grad, None, None, None


def block_encode(x: torch.Tensor, table: torch.Tensor, spec: Spec):
    """Features ``[N, L * F]`` and the in-box mask ``[N]`` of points
    ``[N, 3]``."""
    row, p = block_coords(x.detach(), spec)
    out = _BlockInterp.apply(table, row.reshape(-1), p.reshape(-1, 3), spec)
    return out.reshape(x.shape[0], -1), keep_mask(x, spec)


def hash_corners(x: torch.Tensor, spec: Spec
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (point, level)'s 8 corner rows ``[N, L, 8]`` int64 (corner c
    has bits (c >> 2, c >> 1, c) & 1 on x, y, z) and corner weights
    ``[N, L, 8]``."""
    bl, w = _lattice(x, spec)
    c = bl.to(torch.int64)
    mask = spec.rows - 1
    corners = torch.tensor([[i, j, k] for i in (0, 1) for j in (0, 1)
                            for k in (0, 1)], device=x.device)
    cc = c[:, :, None, :] + corners[None, None]  # [N, L, 8, 3]
    h = cc[..., 0] * _HASH_PRIMES[0]
    h = h ^ (cc[..., 1] * _HASH_PRIMES[1])
    h = h ^ (cc[..., 2] * _HASH_PRIMES[2])
    level = torch.arange(spec.n_levels, device=x.device)
    rows = (h & mask) + (level * spec.rows)[None, :, None]
    f = torch.stack([1.0 - w, w], dim=-1)  # [N, L, 3, 2]
    cw = (f[..., 0, :, None, None] * f[..., 1, None, :, None]
          * f[..., 2, None, None, :]).reshape(*w.shape[:-1], 8)
    return rows, cw


def hash_encode(x: torch.Tensor, table: torch.Tensor, spec: Spec):
    """Features ``[N, L * F]`` and the in-box mask ``[N]``; the table
    gradient is autograd's (an index_add of the weighted cotangent)."""
    rows, cw = hash_corners(x.detach(), spec)
    feats = table.index_select(0, rows.reshape(-1)).view(*cw.shape, -1)
    out = torch.sum(cw[..., None] * feats, dim=-2)
    return out.reshape(x.shape[0], -1), keep_mask(x, spec)


def encode(x: torch.Tensor, table: torch.Tensor, spec: Spec):
    return (block_encode if spec.grid == "block" else hash_encode)(x, table, spec)


def touched_entries(x: torch.Tensor, spec: Spec,
                    seen: torch.Tensor) -> None:
    """Mark in ``seen`` (bool, one per table entry: ``[L * R * lanes]`` for
    the block grid, ``[L * R]`` for the hash grid) the entries the
    interpolation of points ``x`` reads: for the block grid the 8 tile
    vertices around each (point, level), for the hash grid its 8 corner
    rows."""
    if spec.grid == "block":
        row, p = block_coords(x, spec)
        v0 = torch.clamp(torch.floor(p), 0, spec.block_size - 1).to(torch.int64)
        side = spec.side
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    lane = ((v0[..., 0] + dx) * side + v0[..., 1] + dy) * side \
                        + v0[..., 2] + dz
                    seen[(row * spec.lanes + lane).reshape(-1)] = True
    else:
        rows, _ = hash_corners(x, spec)
        seen[rows.reshape(-1)] = True


def entry_count(spec: Spec) -> int:
    L, R = spec.n_levels, spec.rows
    return L * R * (spec.lanes if spec.grid == "block" else 1)

