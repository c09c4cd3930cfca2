"""Baked deferred-shading renderer: a snapshot of a trained field that
renders without the per-sample MLP (render/baked.py of the JAX package).

1. **Bake** (``bake_field``): the trained sigma net is evaluated once per
   grid vertex (through ``encode_position``: ``block_hash_encode``, which
   on the card runs the hand-written ``tent_contract`` kernel, or the hash
   grid's ``hash_encode``), and the
   results are laid out so that every render fetch is one 128-lane row:
   - sigma in halo'd 5^3 block tiles ``[E^3, 128]`` with perfect
     (collision-free) linear block indexing;
   - the geometry features in a voxel-corner table ``[R^3, 128]``: the 8
     trilinear corners x 16 lanes each, corner major.
2. **Render** (``baked_render_rays`` / ``make_baked_image_renderer``):
   ray-box clip -> uniform depths -> pass 1 composites sigma from the tile
   rows -> pass 2 fetches voxel-corner rows for the top-k weighted samples
   only -> the colour net runs once per ray on the accumulated feature and
   the view direction (deferred shading).

It differs from the online renderer as the JAX one does: the field is
frozen at vertex resolution, and the colour net sees the weighted sum of
the features instead of being summed over samples.

Against the JAX module: its ``corner_matmul`` and ``select_onehot`` switches
(two schedules of the same arithmetic, kept there for timing probes) are
not carried over. Pass 2 here is the reference-layout contraction and the
selection a ``torch.gather``. Pass 1 on the card, for float tables, runs
``tent_contract`` over the sigma tile table viewed as a packed
``[n_blocks, 128, 1]`` table: it reads the 8 bracketing vertices instead of
gathering 256-byte rows, and keeps the tent weights in f32 where the plain
form (``_tent_interp``, the JAX arithmetic: CPU tensors and int8 tables)
rounds them to the rows' bfloat16.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as nnf

from indoor_nerf_tpu_torch.models.field import (
    FieldConfig,
    encode_views,
    params_device,
    serving_params,
    sigma_query,
)
from indoor_nerf_tpu_torch.ops.constants import device_constant
from indoor_nerf_tpu_torch.ops.rays import get_rays
from indoor_nerf_tpu_torch.ops.sampling import linspace01
from indoor_nerf_tpu_torch.ops.tent_contract import tent_contract
from indoor_nerf_tpu_torch.utils.checkpoint import atomic_save
from indoor_nerf_tpu_torch.utils.spans import span

BLOCK = 4  # voxels per block edge (5^3 = 125 halo'd vertices <= 128 lanes)
SIDE = BLOCK + 1
LANES = 128
SNAPSHOT_FORMAT = "indoor_nerf_tpu_torch.baked.v1"
_ARRAYS = ("sigma_table", "voxel_geo", "block_max", "sigma_scale", "geo_scale")
# Points per sigma query of the visibility sweep: bounds the encode's eager
# int64 index tensors ([N, L, 3]) whatever the training image size.
_VIS_CHUNK = 1 << 20
CPU_TILE_RAYS = 1024


@dataclasses.dataclass(frozen=True)
class BakedConfig:
    """Static geometry + shading metadata of a baked snapshot."""

    bbox_min: Tuple[float, float, float]
    bbox_max: Tuple[float, float, float]
    resolution: int = 256  # voxels per edge; must be divisible by BLOCK
    n_features: int = 16  # 1 sigma + geo_feat_dim
    i_embed_views: int = 2  # view encoding of the trained field
    multires_views: int = 4
    # Storage dtype; compute is f32. "int8" quantizes both tables,
    # "int8sig" only the sigma tile table, "int8geo" only the voxel-corner
    # geo table.
    table_dtype: str = "bfloat16"
    # Sigma int8 encoding space: "log1p" (trilinear interpolation becomes a
    # geometric mean, which a zero-density corner collapses) or "sqrt" (an
    # arithmetic mean of sqrt; a zero corner merely halves). Ignored unless
    # sigma_quantized.
    sigma_enc: str = "sqrt"
    # Voxel-corner geo table resolution (0 = same as ``resolution``). Geo
    # features are smooth relative to density; resolution / 2 shrinks the
    # table 8x at an unchanged row count per render.
    geo_resolution: int = 0

    @property
    def blocks_per_edge(self) -> int:
        return self.resolution // BLOCK

    @property
    def n_blocks(self) -> int:
        return self.blocks_per_edge ** 3

    @property
    def geo_res(self) -> int:
        return self.geo_resolution or self.resolution

    @property
    def sigma_quantized(self) -> bool:
        return self.table_dtype in ("int8", "int8sig")

    @property
    def geo_quantized(self) -> bool:
        return self.table_dtype in ("int8", "int8geo")


def _ray_aabb(rays_o, rays_d, bmin, bmax, near, far):
    """Per-ray [t0, t1] intersection with the scene box, clipped to
    [near, far]. Rays that miss get t1 <= t0 (a zero-length interval)."""
    inv = 1.0 / torch.where(rays_d.abs() < 1e-9, 1e-9, rays_d)
    ta = (bmin - rays_o) * inv
    tb = (bmax - rays_o) * inv
    t0 = torch.minimum(ta, tb).amax(dim=-1)
    t1 = torch.maximum(ta, tb).amin(dim=-1)
    t0 = torch.clamp_min(t0, near)
    t1 = torch.clamp_max(t1, far)
    return t0, torch.maximum(t1, t0)


def _tent_interp(rows: torch.Tensor, px, py, pz, n_features: int) -> torch.Tensor:
    """Trilinear interpolation over gathered tiles as a tent-product
    contraction: rows ``[M, F*128]`` (f32, bf16 or int8), in-tile positions
    ``[M]`` per axis -> ``[M, F]`` f32.

    The JAX arithmetic: the tent weights are rounded to the rows' float
    dtype (f32 for int8 rows), the products are exact and summed in f32. A
    bf16 einsum would round its output, so both operands are widened."""
    m = rows.shape[0]
    lane = torch.arange(LANES, device=rows.device)
    w = None
    for l, p in ((lane // (SIDE * SIDE), px), ((lane // SIDE) % SIDE, py),
                 (lane % SIDE, pz)):
        t = torch.clamp_min(1.0 - (l.to(torch.float32) - p[:, None]).abs(), 0.0)
        w = t if w is None else w * t
    if rows.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).to(torch.float32)
    rowsf = rows.to(torch.float32).view(m, n_features, LANES)
    return (rowsf * w[:, None, :]).sum(dim=-1)


def _sigma_interp_plain(table, row_idx, px, py, pz) -> torch.Tensor:
    """Pass 1, plain form: gather one tile row per sample, then
    ``_tent_interp``."""
    return _tent_interp(table.index_select(0, row_idx), px, py, pz, 1)[:, 0]


def _sigma_interp(table, row_idx, px, py, pz) -> torch.Tensor:
    """Pass 1: the sigma tile table ``[n_blocks, 128]`` interpolated at
    in-tile positions of tile ``row_idx`` -> ``[M]`` f32.

    A float table on the card is, as it lies, the packed ``[n_blocks, 128,
    1]`` table of a side-5 tile with one feature: ``tent_contract`` reads
    its 8 bracketing vertices (f32 weights). CPU tensors and int8 tables
    take the plain form."""
    if table.device.type == "cuda" and table.dtype.is_floating_point:
        return tent_contract(table.view(-1, LANES, 1), row_idx.to(torch.int32),
                             torch.stack((px, py, pz), dim=-1), SIDE, 1)[:, 0]
    return _sigma_interp_plain(table, row_idx, px, py, pz)


def _weights(sigma, z, rays_d):
    """Standard compositing weights ``[N, S]`` (ops/volume.py semantics,
    1e10 tail)."""
    n = z.shape[0]
    dists = torch.cat([z[:, 1:] - z[:, :-1], z.new_full((n, 1), 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(
        torch.cat([z.new_ones((n, 1)), 1.0 - alpha + 1e-10], dim=-1),
        dim=-1)[:, :-1]
    return alpha * trans


def _visibility_mask(params, config: FieldConfig, mlp_name: str,
                     resolution: int, bmin: np.ndarray, bmax: np.ndarray,
                     cameras: Dict[str, Any], n_samples: int = 128,
                     subsample: int = 4, threshold: float = 1e-3,
                     mask_resolution: int = 32) -> torch.Tensor:
    """Per-vertex visibility keep-mask ``[V^3]`` bool from training views.

    Every ``subsample``-th pixel's ray of every training camera is marched
    through the online field; each sample's compositing weight is
    scatter-maxed into a coarse ``mask_resolution^3`` cell grid; cells with
    weight >= ``threshold`` from some ray are kept, dilated by one cell, and
    the bake vertices are mapped through the coarse mask. Density where no
    training ray ever looked is unconstrained by the loss, and the bake
    would otherwise put such floaters on the grid. The mask is never finer
    than the visibility rays (``R <= H, W``)."""
    dev = params_device(params)
    poses = torch.as_tensor(np.asarray(cameras["poses"], np.float32), device=dev)
    K = torch.as_tensor(np.asarray(cameras["K"], np.float32), device=dev)
    H = int(cameras["H"]) // subsample
    W = int(cameras["W"]) // subsample
    R = max(4, min(mask_resolution, H, W))
    Ks = K * torch.tensor([[1.0 / subsample], [1.0 / subsample], [1.0]],
                          dtype=torch.float32, device=dev)
    near, far = float(cameras["near"]), float(cameras["far"])
    bmin_t = torch.as_tensor(bmin, device=dev)
    bmax_t = torch.as_tensor(bmax, device=dev)
    ts = linspace01(n_samples, dev)

    grid = torch.zeros(R ** 3, dtype=torch.float32, device=dev)
    for c2w in poses:
        rays_o, rays_d = get_rays(H, W, Ks, c2w[:3, :4])
        ro, rd = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        t0, t1 = _ray_aabb(ro, rd, bmin_t, bmax_t, near, far)
        z = t0[:, None] + (t1 - t0)[:, None] * ts[None, :]
        pts = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
        sigma = torch.cat([sigma_query(params, mlp_name, c, config)
                           for c in pts.split(_VIS_CHUNK)]).reshape(z.shape)
        w = _weights(sigma, z, rd).reshape(-1)
        rel = (pts - bmin_t) / (bmax_t - bmin_t) * R
        v = torch.clamp(rel.to(torch.int32), 0, R - 1).long()
        vox = (v[:, 0] * R + v[:, 1]) * R + v[:, 2]
        grid.scatter_reduce_(0, vox, w, "amax", include_self=True)

    keep_cell = (grid >= threshold).reshape(1, 1, R, R, R)
    # Dilate by one cell (3^3 OR): coarse-cell boundaries and the trilinear
    # support of kept voxels are never clipped.
    dil = nnf.max_pool3d(keep_cell.float(), 3, stride=1, padding=1)[0, 0] > 0
    V = resolution + 1
    vi = torch.clamp((torch.arange(V, device=dev) * R) // resolution, 0, R - 1)
    return dil[vi[:, None, None], vi[None, :, None], vi[None, None, :]].reshape(-1)


def _percentile(x: torch.Tensor, pct: float) -> torch.Tensor:
    """``jnp.percentile(x, pct, axis=0)`` (linear interpolation) of a
    ``[n, c]`` float32 tensor, one column at a time: ``torch.quantile``
    refuses inputs over 2^24 elements, and a baked grid's vertex table is far
    over. The fractional index is float32, as in jnp and in numpy on float32
    input: at pct 99.9 a float64 index moves the result by ~1e-6 relative."""
    n = x.shape[0]
    pos = np.float32(pct) / np.float32(100.0) * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), min(int(np.ceil(pos)), n - 1)
    hi_w = float(pos - np.float32(lo))
    out = []
    for c in range(x.shape[1]):
        col = torch.sort(x[:, c]).values
        out.append(col[lo] * (1.0 - hi_w) + col[hi] * hi_w)
    return torch.stack(out)


@torch.no_grad()
def bake_field(params: Dict[str, Any], config: FieldConfig,
               resolution: int = 256, table_dtype: str = "bfloat16",
               blocks_per_chunk: int = 2048,
               train_cameras: Optional[Dict[str, Any]] = None,
               vis_threshold: float = 1e-3, vis_subsample: int = 4,
               geo_resolution: int = -1, int8_clip_pct: float = 100.0,
               sigma_enc: str = "sqrt") -> Dict[str, Any]:
    """Bake a trained grid field into a block-tile snapshot.

    Returns ``{"sigma_table": [n_blocks, 128], "voxel_geo": [R^3, 128],
    "block_max": [n_blocks], "color_net": [{"w": ...}, ...], "config":
    BakedConfig}`` plus ``sigma_scale`` / ``geo_scale`` for int8 tables, on
    the device of the params. ``block_max`` is the largest sigma
    per block, in density units.

    ``train_cameras`` ({"poses" [V,3,4], "K", "H", "W", "near", "far"})
    enables visibility culling: vertices that carry < ``vis_threshold``
    compositing weight from every training ray get a sigma of -1e4 before
    baking (see ``_visibility_mask``).

    The vertex sweep queries ``blocks_per_chunk * 128`` points at a time
    through the encode of the field's grid (``encode_position``: the block
    grid or the hash grid); a block table is packed once for it
    (``serving_params``), so on the card every chunk is one ``tent_contract``
    launch. ``geo_resolution`` -1 is ``resolution // 2``, 0 the full
    resolution. It takes no quantizer state: a field trained with A-CAQ is
    baked from its unquantized params, as the JAX bake bakes it."""
    if not config.uses_grid:
        raise ValueError("bake_field needs a NeRFSmall-style grid field")
    if sigma_enc not in ("sqrt", "log1p"):
        raise ValueError(f"sigma_enc must be 'sqrt' or 'log1p', got "
                         f"{sigma_enc!r}")
    if resolution % BLOCK != 0:
        raise ValueError(f"resolution must be divisible by {BLOCK}")
    if geo_resolution < 0:
        geo_resolution = resolution // 2
    if geo_resolution and resolution % geo_resolution != 0:
        # The stride keeps geo vertices an exact subset of bake vertices,
        # so the coarser table reuses the one vertex sweep.
        raise ValueError("geo_resolution must divide resolution")
    if table_dtype not in ("bfloat16", "float32", "int8", "int8sig", "int8geo"):
        raise ValueError(f"table_dtype {table_dtype!r}")
    geo_dim = config.geo_feat_dim
    if geo_dim > 15:
        raise ValueError("voxel-corner rows fit geo_feat_dim <= 15")
    src = config.grid if config.grid is not None else config.block_grid
    mlp_name = "fine" if "fine" in params else "coarse"
    bc = BakedConfig(
        bbox_min=tuple(float(v) for v in src.bbox_min),
        bbox_max=tuple(float(v) for v in src.bbox_max),
        resolution=resolution, n_features=1 + geo_dim,
        i_embed_views=config.i_embed_views,
        multires_views=config.multires_views,
        table_dtype=table_dtype, geo_resolution=geo_resolution,
        sigma_enc=sigma_enc)
    E, n_blocks = bc.blocks_per_edge, bc.n_blocks
    V = resolution + 1  # vertices per edge
    params = serving_params(params, config)
    dev = params_device(params)

    bmin = np.asarray(bc.bbox_min, np.float32)
    bmax = np.asarray(bc.bbox_max, np.float32)
    bmin_t = torch.as_tensor(bmin, device=dev)
    voxel = torch.as_tensor((bmax - bmin) / resolution, device=dev)  # [3]
    dtype = torch.float32 if table_dtype == "float32" else torch.bfloat16

    # 1. Query every unique vertex once: [V^3] sigma, [V^3, geo] features.
    chunk = blocks_per_chunk * LANES
    vert_sigma = torch.empty(V ** 3, dtype=dtype, device=dev)
    geo_table = torch.empty((V ** 3, geo_dim), dtype=dtype, device=dev)
    with span("bake_vertices"):
        for start in range(0, V ** 3, chunk):
            ids = torch.arange(start, min(start + chunk, V ** 3), device=dev)
            vi = torch.stack([ids // (V * V), (ids // V) % V, ids % V],
                             dim=-1).to(torch.float32)
            sigma, geo = sigma_query(params, mlp_name, bmin_t + vi * voxel,
                                     config, with_geo=True)
            vert_sigma[start:start + chunk] = sigma.to(dtype)
            geo_table[start:start + chunk] = geo.to(dtype)

    if train_cameras is not None:
        with span("bake_visibility"):
            keep_vert = _visibility_mask(
                params, config, mlp_name, resolution, bmin, bmax,
                train_cameras, subsample=vis_subsample, threshold=vis_threshold)
        # Pre-ReLU sigma: a large negative value renders as zero density.
        vert_sigma = torch.where(keep_vert, vert_sigma,
                                 torch.tensor(-1e4, dtype=dtype, device=dev))

    # Optional int8 tables: sigma in sqrt or log1p space with one scale
    # (interpolation then happens in that space), geo with per-feature
    # symmetric scales; ``int8_clip_pct`` < 100 sets each geo scale from
    # that percentile of |value| instead of the largest.
    sigma_scale = geo_scale = None
    if bc.sigma_quantized:
        v = torch.relu(vert_sigma.float())
        enc = torch.sqrt(v) if sigma_enc == "sqrt" else torch.log1p(v)
        sigma_scale = torch.clamp_min(enc.max() / 127.0, 1e-8)
        vert_sigma = torch.round(enc / sigma_scale).to(torch.int8)
    if bc.geo_quantized:
        g32 = geo_table.float()
        amax = (_percentile(g32.abs(), int8_clip_pct) if int8_clip_pct < 100.0
                else g32.abs().amax(dim=0))
        geo_scale = torch.clamp_min(amax / 127.0, 1e-8)
        geo_table = torch.clamp(torch.round(g32 / geo_scale), -127, 127
                                ).to(torch.int8)

    # 2. Sigma tile table [n_blocks, 128]: each block's 5^3 halo'd vertices
    #    in one 128-lane row (pad lanes 0).
    lane = torch.arange(LANES, device=dev)[None, :]
    b = torch.arange(n_blocks, device=dev)[:, None]
    live = lane < SIDE ** 3
    vid = (((b // (E * E) * BLOCK + lane // (SIDE * SIDE)) * V
            + ((b // E) % E * BLOCK + (lane // SIDE) % SIDE)) * V
           + (b % E * BLOCK + lane % SIDE))
    vid = torch.where(live, vid, 0)
    sigma_table = vert_sigma[vid.reshape(-1)].view(n_blocks, LANES)
    sigma_table = sigma_table * live.to(sigma_table.dtype)
    block_max = torch.relu(sigma_table.float()).amax(dim=1)
    if bc.sigma_quantized:  # back to density units
        block_max = (torch.square(block_max * sigma_scale)
                     if sigma_enc == "sqrt"
                     else torch.expm1(block_max * sigma_scale))
    del vid

    # 3. Voxel corner table [R^3, 128]: row = the voxel's 8 corner vertices
    #    x (geo features padded to 16 lanes each), corner major
    #    (c = dx*4 + dy*2 + dz): one row per selected render sample.
    R = bc.geo_res
    vstride = resolution // R  # geo vertex -> bake vertex index stride
    stride = LANES // 8
    voxel_geo = torch.zeros((R ** 3, 8, stride), dtype=geo_table.dtype,
                            device=dev)
    for start in range(0, R ** 3, chunk):
        vox = torch.arange(start, min(start + chunk, R ** 3), device=dev)
        x, y, z = vox // (R * R), (vox // R) % R, vox % R
        for c, (dx, dy, dz) in enumerate(np.ndindex(2, 2, 2)):
            vid = (((x + dx) * V + (y + dy)) * V + (z + dz)) * vstride
            voxel_geo[start:start + chunk, c, :geo_dim] = geo_table[vid]

    out = {
        "sigma_table": sigma_table,
        "voxel_geo": voxel_geo.view(R ** 3, LANES),
        "block_max": block_max,
        "color_net": [{k: v.detach().clone() for k, v in layer.items()}
                      for layer in params[mlp_name].color_net],
        "config": bc,
    }
    if sigma_scale is not None:
        out["sigma_scale"] = sigma_scale
    if geo_scale is not None:
        out["geo_scale"] = geo_scale
    return out


def save_baked(path: str, baked: Dict[str, Any]) -> None:
    """Write a baked snapshot to one file (the deployable artifact: tables,
    colour net, geometry): a ``torch.save`` dict of CPU tensors and the
    config as plain values, written atomically."""
    cfg = dataclasses.asdict(baked["config"])
    cfg["bbox_min"], cfg["bbox_max"] = list(cfg["bbox_min"]), list(cfg["bbox_max"])
    payload: Dict[str, Any] = {"format": SNAPSHOT_FORMAT, "config": cfg}
    payload.update({k: baked[k].detach().cpu() for k in _ARRAYS if k in baked})
    for i, layer in enumerate(baked["color_net"]):
        payload.update({f"color_net.{i}.{k}": v.detach().cpu()
                        for k, v in layer.items()})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    atomic_save(path, payload)


def load_baked(path: str, device=None) -> Dict[str, Any]:
    """Load a snapshot written by ``save_baked`` onto ``device``; a snapshot
    written by the JAX package's ``save_baked`` (flax msgpack) is read
    through ``bridge.load_jax_baked``."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic != b"PK\x03\x04":
        from indoor_nerf_tpu_torch.bridge import load_jax_baked

        return load_jax_baked(path, device)
    payload = torch.load(path, weights_only=True, map_location=device)
    if payload.get("format") != SNAPSHOT_FORMAT:
        raise ValueError(f"{path}: not a baked snapshot (format "
                         f"{payload.get('format')!r}, expected "
                         f"{SNAPSHOT_FORMAT!r})")
    cfg = dict(payload["config"])
    cfg["bbox_min"], cfg["bbox_max"] = tuple(cfg["bbox_min"]), tuple(cfg["bbox_max"])
    baked: Dict[str, Any] = {k: payload[k] for k in _ARRAYS if k in payload}
    layers: Dict[int, Dict[str, torch.Tensor]] = {}
    for key, v in payload.items():
        if key.startswith("color_net."):
            _, i, name = key.split(".")
            layers.setdefault(int(i), {})[name] = v
    baked["color_net"] = [layers[i] for i in sorted(layers)]
    baked["config"] = BakedConfig(**cfg)
    return baked


def _tile_samples(bc: BakedConfig, rays_o, rays_d, near, far, n_samples: int,
                  t_bounds=None):
    """Uniform depths along each ray's box interval and where they fall in
    the sigma tile table: ``(z [N, S], rel, row_idx [N, S] int64, p)`` with
    ``rel`` the three vertex-space coordinate planes ``[N, S]`` (vertex
    spacing 1) and ``p`` the three in-tile position planes of tile
    ``row_idx``."""
    dev = rays_o.device
    E = bc.blocks_per_edge
    # Made once: a fresh host-to-card copy waits for the card each tile.
    bmin = device_constant(bc.bbox_min, torch.float32, dev)
    bmax = device_constant(bc.bbox_max, torch.float32, dev)
    t0, t1 = _ray_aabb(rays_o, rays_d, bmin, bmax, near, far)
    if t_bounds is not None:
        # Where the guided interval and the box interval are disjoint, the
        # full box interval stays (not one repeated sample at t0).
        g0 = torch.maximum(t0, t_bounds[0])
        g1 = torch.minimum(t1, t_bounds[1])
        empty = g1 <= g0
        t0 = torch.where(empty, t0, g0)
        t1 = torch.where(empty, t1, g1)
    ts = linspace01(n_samples, dev)
    z = t0[:, None] + (t1 - t0)[:, None] * ts[None, :]  # [N, S]
    scale = bc.resolution / (bmax - bmin)  # [3]
    top = bc.resolution - 1e-4
    rel = [torch.clamp((rays_o[:, None, a] + rays_d[:, None, a] * z - bmin[a])
                       * scale[a], 0.0, top) for a in range(3)]
    # Perfect block indexing per axis.
    blk = [torch.clamp(torch.div(r, BLOCK, rounding_mode="floor")
                       .to(torch.int32), 0, E - 1) for r in rel]
    row_idx = ((blk[0] * E + blk[1]) * E + blk[2]).long()
    p = [r - b.to(torch.float32) * BLOCK for r, b in zip(rel, blk)]
    return z, rel, row_idx, p


def baked_render_rays(baked: Dict[str, Any], rays_o: torch.Tensor,
                      rays_d: torch.Tensor, viewdirs: torch.Tensor,
                      near: float, far: float, n_samples: int = 128,
                      white_bkgd: bool = True, k_geo: Optional[int] = 4,
                      t_bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      renorm_k: bool = True) -> Dict[str, torch.Tensor]:
    """Render a ``[N, 3]`` ray batch from a baked snapshot.

    Two passes split the fetch volume: (1) density, one sigma tile per
    sample -> weights; (2) features, one voxel-corner row for each of the
    ``k_geo`` highest-weight samples per ray (``None``: every sample),
    their weights rescaled to the ray's full opacity with ``renorm_k``.
    Then one colour-net evaluation per ray.

    ``t_bounds``: optional per-ray ``([N], [N])`` sampling interval along
    the ray, intersected with the scene box (the guided renderer's depth
    interval); where the two are disjoint the full box interval is kept.

    Returns rgb/depth/acc/disp maps and ``t_lo`` / ``t_hi``, the depths at
    which the ray's cumulative weight passes 2% and 98% of its opacity."""
    bc: BakedConfig = baked["config"]
    dev = rays_o.device
    n = rays_o.shape[0]

    with span("baked_sample"):
        z, (relx, rely, relz), row_idx, p = _tile_samples(
            bc, rays_o, rays_d, near, far, n_samples, t_bounds)

    with span("baked_pass1"):
        sigma = _sigma_interp(baked["sigma_table"], row_idx.reshape(-1),
                              *(a.reshape(-1) for a in p)).reshape(n, n_samples)
        if bc.sigma_quantized:
            # Interpolated in the encoding space, then dequantized.
            enc = torch.relu(sigma) * baked["sigma_scale"]
            sigma = torch.square(enc) if bc.sigma_enc == "sqrt" else torch.expm1(enc)

    with span("baked_composite"):
        weights = _weights(sigma, z, rays_d)  # [N, S]
        acc = weights.sum(dim=-1)
        depth = (weights * z).sum(dim=-1)
        # Weighted 2% / 98% depth quantiles: the span that carries the
        # ray's opacity mass (first sample at which the cumulative weight
        # passes). Rays with acc ~ 0 give z[0]; the guided caller falls
        # back to the full range for those.
        cumw = torch.cumsum(weights, dim=-1)
        lo_i = torch.argmax((cumw >= 0.02 * acc[:, None]).to(torch.uint8), dim=-1)
        hi_i = torch.argmax((cumw >= 0.98 * acc[:, None]).to(torch.uint8), dim=-1)
        t_lo = z.gather(1, lo_i[:, None])[:, 0]
        t_hi = z.gather(1, hi_i[:, None])[:, 0]

    with span("baked_pass2"):
        if k_geo is not None and k_geo < n_samples:
            w_sel, sel = torch.topk(weights, k_geo, dim=-1)  # [N, k]
            if renorm_k:
                # Top-k drops the unselected samples' weight mass, which
                # dims the accumulated feature; rescale to the ray's full
                # opacity (exact at k = S).
                w_sel = w_sel * (acc / torch.clamp_min(w_sel.sum(dim=-1), 1e-9)
                                 )[:, None]
            selx, sely, selz = (r.gather(1, sel) for r in (relx, rely, relz))
        else:
            k_geo = n_samples
            w_sel = weights
            selx, sely, selz = relx, rely, relz
        R = bc.geo_res
        if R != bc.resolution:  # corner table on a coarser geo grid
            f = R / bc.resolution
            selx, sely, selz = selx * f, sely * f, selz * f
        v0 = [torch.clamp(s.to(torch.int32), 0, R - 1) for s in (selx, sely, selz)]
        vox = ((v0[0] * R + v0[1]) * R + v0[2]).long().reshape(-1)  # [M]
        frac = torch.stack([s - v.to(torch.float32)
                            for s, v in zip((selx, sely, selz), v0)], dim=-1)
        stride = LANES // 8  # lanes per corner in the voxel_geo row
        geo_dim = bc.n_features - 1
        crows = baked["voxel_geo"].index_select(0, vox).view(n, k_geo, 8, stride)
        corner = device_constant(list(np.ndindex(2, 2, 2)), torch.float32,
                                 dev)  # [8, 3], the bake's corner order
        cw = torch.where(corner[None, None, :, :] == 1.0, frac[:, :, None, :],
                         1.0 - frac[:, :, None, :])  # [N, k, 8, 3]
        cw = cw[..., 0] * cw[..., 1] * cw[..., 2]  # [N, k, 8]
        if crows.dtype == torch.bfloat16:  # the JAX einsum's operand dtype
            cw = cw.to(torch.bfloat16).to(torch.float32)
        geo = (crows[..., :geo_dim].to(torch.float32) * cw[..., None]).sum(dim=2)
        if bc.geo_quantized:
            geo = geo * baked["geo_scale"][None, None, :]
        feat_ray = (w_sel[..., None] * geo).sum(dim=1)  # [N, geo]

    with span("baked_color"):
        # Deferred shading: one colour-net pass per ray.
        h = torch.cat([encode_views(viewdirs, bc.i_embed_views,
                                    bc.multires_views), feat_ray], dim=-1)
        for l, layer in enumerate(baked["color_net"]):
            h = h @ layer["w"]
            if "b" in layer:
                h = h + layer["b"]
            if l != len(baked["color_net"]) - 1:
                h = torch.relu(h)
        rgb = torch.sigmoid(h) * acc[..., None]
        if white_bkgd:
            rgb = rgb + (1.0 - acc[..., None])
        disp = 1.0 / torch.clamp_min(depth / torch.clamp_min(acc, 1e-10), 1e-10)
    return {"rgb_map": rgb, "depth_map": depth, "acc_map": acc,
            "disp_map": disp, "t_lo": t_lo, "t_hi": t_hi}


def baked_bytes_per_ray(baked: Dict[str, Any], n_samples: int,
                        k_geo: Optional[int]) -> int:
    """Device bytes one ray of ``baked_render_rays`` holds at its peak,
    reckoned from the shapes: ~32 ``[N, S]`` planes of 4 bytes for the
    depths, coordinates, indices and weights; in the plain form of pass 1
    one 128-lane tile row per sample (the gathered row, its f32 copy and
    four f32 weight planes); in pass 2 one 128-lane row per selected
    sample (the gathered row, its f32 copy and the weighted product)."""
    sigma_table, voxel_geo = baked["sigma_table"], baked["voxel_geo"]
    per_sample = 32 * 4
    if not (sigma_table.device.type == "cuda"
            and sigma_table.dtype.is_floating_point):
        per_sample += LANES * (sigma_table.element_size() + 5 * 4)
    k = n_samples if k_geo is None else min(k_geo, n_samples)
    return n_samples * per_sample + k * LANES * (voxel_geo.element_size() + 8) + 1024


def default_baked_tile_rays(baked: Dict[str, Any], n_samples: int,
                            k_geo: Optional[int]) -> int:
    """Rays per tile: a quarter of the card's free memory at
    ``baked_bytes_per_ray``, as a power of two in [2^10, 2^20]; 1024 on
    the CPU."""
    dev = baked["sigma_table"].device
    if dev.type != "cuda":
        return CPU_TILE_RAYS
    free, _ = torch.cuda.mem_get_info(dev)
    n = max(1, free // 4 // baked_bytes_per_ray(baked, n_samples, k_geo))
    return int(min(1 << 20, max(1 << 10, 1 << (n.bit_length() - 1))))


def make_baked_image_renderer(baked: Dict[str, Any], H: int, W: int,
                              tile_rays: Optional[int] = None,
                              n_samples: int = 128, white_bkgd: bool = True,
                              k_geo: Optional[int] = 4, guided: int = 0,
                              n_coarse: int = 128, margin_frac: float = 0.04,
                              acc_thresh: float = 0.5, pose_block: int = 4,
                              renorm_k: bool = True):
    """A full-image renderer ``(c2w, K, near, far) -> maps`` over a baked
    snapshot, on the snapshot's device. ``c2w`` ``[3, 4]`` renders one
    frame, ``[B, 3, 4]`` a block of poses (maps then carry a leading B
    axis); ``pose_block`` is advertised on the returned function for
    callers that render paths. ``tile_rays=None`` sizes the ray tiles from
    the card's free memory (``default_baked_tile_rays``).

    ``guided > 0`` enables depth-guided two-level rendering: the image is
    first rendered at 1/guided resolution with ``n_coarse`` uniform
    samples (coarse pixel i casts through the centre of its g x g block),
    then each full-resolution ray marches only ``n_samples`` (choose it
    small, e.g. 16-32) samples inside a conservative depth interval: the
    3x3-neighbourhood min / max of the coarse rays' 2% / 98% depths, widened
    by ``margin_frac`` x (far - near). Coarse pixels whose whole 3x3
    neighbourhood has opacity below ``acc_thresh`` fall back to the full
    [near, far] range, so misses never clip geometry."""
    dev = baked["sigma_table"].device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    def tiled(ro, rd, vd, near, far, n_s, bounds=None):
        tile = tile_rays or default_baked_tile_rays(baked, n_s, k_geo)
        outs: Dict[str, list] = {}
        for s in range(0, ro.shape[0], tile):
            sl = slice(s, s + tile)
            tb = None if bounds is None else (bounds[0][sl], bounds[1][sl])
            out = baked_render_rays(baked, ro[sl], rd[sl], vd[sl], near, far,
                                    n_samples=n_s, white_bkgd=white_bkgd,
                                    k_geo=k_geo, t_bounds=tb, renorm_k=renorm_k)
            for k, v in out.items():
                outs.setdefault(k, []).append(v)
        return {k: torch.cat(v) for k, v in outs.items()}

    def rays_of(h, w, K, c2ws):
        rays = [get_rays(h, w, K, c2w) for c2w in c2ws]
        ro = torch.stack([r[0] for r in rays]).reshape(-1, 3)
        rd = torch.stack([r[1] for r in rays]).reshape(-1, 3)
        return ro, rd, rd / torch.linalg.norm(rd, dim=-1, keepdim=True)

    @torch.inference_mode()
    def render_image(c2ws, K, near, far):
        B = c2ws.shape[0]
        rays_o, rays_d, viewdirs = rays_of(H, W, K, c2ws)
        bounds = None
        if guided:
            g = guided
            Hc, Wc = -(-H // g), -(-W // g)
            # Coarse intrinsics: scaled by 1/g, the principal point shifted
            # so that coarse pixel i casts through the centre of its block.
            off = (g - 1) / (2.0 * g)
            Kc = K * torch.tensor([[1.0 / g], [1.0 / g], [1.0]],
                                  dtype=torch.float32, device=dev)
            Kc[0, 2] -= off
            Kc[1, 2] -= off
            coarse = tiled(*rays_of(Hc, Wc, Kc, c2ws), near, far, n_coarse)
            hit = coarse["acc_map"].reshape(B, Hc, Wc) > acc_thresh
            big = 3e38
            dmin = torch.where(hit, coarse["t_lo"].reshape(B, Hc, Wc), big)
            dmax = torch.where(hit, coarse["t_hi"].reshape(B, Hc, Wc), -big)
            # Per-frame 3x3 neighbourhood min / max; the padding (-inf)
            # never wins, so edges stay valid.
            dmin = -nnf.max_pool2d(-dmin[:, None], 3, stride=1, padding=1)[:, 0]
            dmax = nnf.max_pool2d(dmax[:, None], 3, stride=1, padding=1)[:, 0]
            m = f32(margin_frac) * (f32(far) - f32(near))
            no_hit = dmax < -1e37  # whole neighbourhood below acc_thresh
            dmin = torch.where(no_hit, f32(near), dmin - m)
            dmax = torch.where(no_hit, f32(far), dmax + m)
            # Nearest-neighbour upsample to full resolution, per frame.
            dmin = dmin.repeat_interleave(g, 1).repeat_interleave(g, 2)
            dmax = dmax.repeat_interleave(g, 1).repeat_interleave(g, 2)
            bounds = (dmin[:, :H, :W].reshape(-1), dmax[:, :H, :W].reshape(-1))
        flat = tiled(rays_o, rays_d, viewdirs, near, far, n_samples, bounds)
        return {
            "rgb_map": flat["rgb_map"].reshape(B, H, W, 3),
            "depth_map": flat["depth_map"].reshape(B, H, W),
            "acc_map": flat["acc_map"].reshape(B, H, W),
            "disp_map": flat["disp_map"].reshape(B, H, W),
        }

    def render_fn(c2w, K, near, far):
        c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=dev)
        single = c2w.dim() == 2
        c2w = c2w[None] if single else c2w
        K = torch.as_tensor(np.asarray(K, np.float32), device=dev)
        out = render_image(c2w[:, :3, :4], K, float(near), float(far))
        return {k: v[0] for k, v in out.items()} if single else out

    render_fn.pose_block = int(pose_block)
    return render_fn
