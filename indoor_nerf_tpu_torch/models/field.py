"""The radiance field: encoders + MLP + out-of-bbox masking
(models/field.py of the JAX package) without quantization, appearance
latents or tensor parallelism.

Three encoders, as ``i_embed`` says: 3, the block-hash grid (flat or
ray-structured); 1, the multiresolution hash grid; 0 (any other value, as
in the JAX package), the frequency PE. ``params`` is a dict: ``"table"``
(the block table ``[L*R, F*lpf]`` or the hash table ``[L*T, F]``; none for
PE), ``"coarse"`` and, with ``n_importance > 0``, ``"fine"``: NeRFSmall
nets for the grids (with ``predict_normals`` each with a normal net),
NeRFBig nets for PE.

Two schedules act on training queries only (``step`` given; evaluation
passes none): ``freq_anneal_iters`` fades the grid levels in one after
another (FreeNeRF's schedule on grid levels, ``level_anneal_weights``) and
``view_anneal_iters`` ramps the encoded view directions from zero.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from indoor_nerf_tpu_torch.models.mlp import (
    apply_nerf_big,
    init_nerf_big,
    init_nerf_small,
)
from indoor_nerf_tpu_torch.ops.blockhash import (
    BlockHashConfig,
    block_hash_encode,
    block_hash_encode_grouped,
    block_hash_encode_strided,
    gather_table,
    init_block_table,
)
from indoor_nerf_tpu_torch.ops.encoding import (
    HashGridConfig,
    hash_encode,
    init_hash_table,
    positional_encode,
    positional_encode_dim,
    sh_encode,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Static model configuration (the JAX FieldConfig's fields that the
    port runs; same defaults)."""

    grid: Optional[HashGridConfig] = None
    block_grid: Optional[BlockHashConfig] = None
    # 3 = block-hash, 1 = hash grid, else positional encoding. The JAX
    # default is 1; the port's stays 3, the block grid it began with (the
    # CLI always passes --i_embed, whose default is 1).
    i_embed: int = 3
    i_embed_views: int = 2  # 2 = SH degree 4, else positional encoding
    multires: int = 10
    multires_views: int = 4
    use_viewdirs: bool = True
    # NeRFSmall's normal net: 3 more output channels, the unit normal
    # (NeRFBig has none: a PE field composites no normal map).
    predict_normals: bool = False
    n_importance: int = 0
    # NeRFSmall (the grid encoders)
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    # NeRFBig (PE)
    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    compute_dtype: str = "float32"  # or "bfloat16": NeRFSmall's products
    # Training schedules (0 = off): the grid levels fade in over
    # freq_anneal_iters steps, the view encoding over view_anneal_iters.
    freq_anneal_iters: int = 0
    view_anneal_iters: int = 0

    @property
    def input_ch(self) -> int:
        if self.i_embed == 1:
            return self.grid.out_dim
        if self.i_embed == 3:
            return self.block_grid.out_dim
        return positional_encode_dim(self.multires)

    @property
    def uses_grid(self) -> bool:
        return self.i_embed in (1, 3)

    @property
    def input_ch_views(self) -> int:
        if not self.use_viewdirs:
            return 0
        if self.i_embed_views == 2:
            return 16  # SH degree 4
        return positional_encode_dim(self.multires_views)

    @property
    def torch_compute_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else None


def field_output_channels(config: FieldConfig) -> int:
    """Channels of the raw field output: rgb logits, sigma and, with
    ``predict_normals``, the normal (JAX field.py:144)."""
    return 7 if config.predict_normals else 4


def init_field_params(generator: torch.Generator, config: FieldConfig,
                      device=None) -> Params:
    """Fresh params: the grid's table (shared by both nets), the coarse net
    and, with ``n_importance > 0``, the fine one: NeRFSmall for the grids,
    NeRFBig for PE (whose coarse net has 5 outputs where a fine pass
    follows and no view head).

    Same shapes and distributions as the JAX init; the numbers differ
    (torch.Generator is not jax.random), so parity tests bridge weights.
    The MLP weights are ``nn.Parameter``s; the table is a plain tensor
    until a train state marks every leaf trainable (``train/step.py``)."""
    params: Params = {}
    names = ("coarse", "fine") if config.n_importance > 0 else ("coarse",)
    if config.uses_grid:
        if config.i_embed == 1:
            params["table"] = init_hash_table(generator, config.grid, device)
        else:
            params["table"] = init_block_table(generator, config.block_grid,
                                               device)
        for name in names:
            params[name] = init_nerf_small(
                generator, input_ch=config.input_ch,
                input_ch_views=config.input_ch_views,
                num_layers=config.num_layers, hidden_dim=config.hidden_dim,
                geo_feat_dim=config.geo_feat_dim,
                num_layers_color=config.num_layers_color,
                hidden_dim_color=config.hidden_dim_color,
                predict_normals=config.predict_normals, device=device)
    else:
        for name in names:
            fine = name == "fine"
            params[name] = init_nerf_big(
                generator, D=config.netdepth_fine if fine else config.netdepth,
                W=config.netwidth_fine if fine else config.netwidth,
                input_ch=config.input_ch, input_ch_views=config.input_ch_views,
                output_ch=5 if config.n_importance > 0 else 4,
                use_viewdirs=config.use_viewdirs, device=device)
    return params


def params_device(params: Params) -> torch.device:
    """The device the params live on."""
    if "table" in params:
        return params["table"].device
    return next(params["coarse"].parameters()).device


def serving_params(params: Params, config: FieldConfig) -> Params:
    """Params with the table packed and cast once as the row gather reads
    it (``gather_table``: vertex major, bf16 for the flagship). The JAX
    encode recasts the f32 master on every call; a server holds the table
    fixed, so it packs once. The copy is valid only while the params do not
    change: re-derive it after any update. It carries no gradient. The
    tile-interp route gathers whole rows of the master layout, so its table
    stays as it is, and so does the hash grid's."""
    out = dict(params)
    if "table" not in params:
        return out
    table = params["table"].detach()
    if config.i_embed == 3 and not config.block_grid.uses_tile_interp:
        table = gather_table(table, config.block_grid)
    out["table"] = table
    return out


def _ramp(step: int, iters: int) -> float:
    """``clip(step / iters, 0, 1)`` rounded to float32, as the JAX schedules
    compute it from their int32 step."""
    return float(np.clip(np.float32(step) / np.float32(iters), 0.0, 1.0))


def level_anneal_weights(step: int, n_levels: int, anneal_iters: int,
                         device=None) -> torch.Tensor:
    """Per-level feature weights ``[n_levels]`` of the frequency anneal
    (JAX field.py:387): level ``l`` gets ``clip(p * (L - 1) + 1 - l, 0,
    1)`` at progress ``p = clip(step / anneal_iters, 0, 1)``, so level 0 is
    always on, the frontier level fades in and every level is on from
    ``anneal_iters``. The scalar part is computed on the host in float32
    (no copy to the card); the levels on ``device``."""
    frontier = float(np.float32(_ramp(step, anneal_iters))
                     * np.float32(n_levels - 1) + np.float32(1.0))
    levels = torch.arange(n_levels, dtype=torch.float32, device=device)
    return torch.clamp(frontier - levels, 0.0, 1.0)


def _apply_level_anneal(feats: torch.Tensor, config: FieldConfig,
                        step: Optional[int]) -> torch.Tensor:
    """Grid features ``[N, L*F]`` times the anneal's level weights (JAX
    field.py:402); unchanged when the anneal is off or for an evaluation
    query (no ``step``)."""
    if config.freq_anneal_iters <= 0 or step is None or not config.uses_grid:
        return feats
    g = config.block_grid if config.i_embed == 3 else config.grid
    L, F = g.n_levels, g.n_features_per_level
    w = level_anneal_weights(step, L, config.freq_anneal_iters, feats.device)
    return (feats.reshape(-1, L, F) * w[None, :, None]).reshape(feats.shape)


def encode_position(x: torch.Tensor, params: Params, config: FieldConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode flat ``[N, 3]`` positions -> (feats ``[N, input_ch]``,
    keep_mask ``[N]``; all True for PE)."""
    if config.i_embed == 1:
        return hash_encode(x, params["table"], config.grid)
    if config.i_embed == 3:
        return block_hash_encode(x, params["table"], config.block_grid)
    feats = positional_encode(x, config.multires)
    return feats, torch.ones(x.shape[0], dtype=torch.bool, device=x.device)


def encode_views(dirs: torch.Tensor, i_embed_views: int,
                 multires_views: int) -> torch.Tensor:
    """SH of degree 4 (``i_embed_views`` 2) or PE of ``multires_views``
    frequencies (0) of the view directions."""
    if i_embed_views == 2:
        return sh_encode(dirs, degree=4)
    return positional_encode(dirs, multires_views)


def sigma_query(params: Params, mlp_name: str, pts: torch.Tensor,
                config: FieldConfig, with_geo: bool = False):
    """Density-only query ``[N]`` (encode + sigma net), zero outside the
    bbox. ``with_geo`` also returns the sigma net's geometry features
    ``[N, geo_feat_dim]`` (not masked), which the bake stores per vertex;
    grid fields only. For PE the whole NeRFBig runs, with the view
    encoding of zero directions (the JAX form)."""
    feats, keep = encode_position(pts, params, config)
    if not config.uses_grid:
        view_feats = (encode_views(torch.zeros_like(pts), config.i_embed_views,
                                   config.multires_views)
                      if config.use_viewdirs else None)
        raw = apply_nerf_big(params[mlp_name], feats, view_feats)
        return torch.where(keep, raw[..., 3], 0.0)
    h = feats
    sigma_net = params[mlp_name].sigma_net
    for l, layer in enumerate(sigma_net):
        h = h @ layer["w"]
        if l != len(sigma_net) - 1:
            h = torch.relu(h)
    sigma = torch.where(keep, h[..., 0], 0.0)
    return (sigma, h[..., 1:]) if with_geo else sigma


def query_field(params: Params, mlp_name: str, pts: torch.Tensor,
                viewdirs: Optional[torch.Tensor], config: FieldConfig,
                step: Optional[int] = None) -> torch.Tensor:
    """Query the field on an ``[R, S, 3]`` sample grid -> raw ``[R, S, C]``
    (C = 4, 7 with ``predict_normals``; 5 for a PE net without view head
    ahead of a fine pass).

    With ``ray_groups`` or ``ray_strides`` set on the block grid the encode
    is the ray-structured one (JAX field.py:519-546); else the flat one.
    ``viewdirs`` ``[R, 3]`` unit directions are encoded once per ray and
    broadcast over the samples. A training query (``step`` given) applies
    the level and view anneals. Sigma is zeroed outside the bbox; the
    normal channels are kept as they are."""
    r, s, _ = pts.shape
    bg = config.block_grid
    with record_function("encode"):
        if config.i_embed == 3 and (bg.ray_groups is not None
                                    or bg.ray_strides is not None):
            enc = (block_hash_encode_grouped if bg.ray_groups is not None
                   else block_hash_encode_strided)
            feats3, keep2 = enc(pts, params["table"], bg)
            feats, keep = feats3.reshape(r * s, -1), keep2.reshape(r * s)
        else:
            feats, keep = encode_position(pts.reshape(-1, 3), params, config)
        feats = _apply_level_anneal(feats, config, step)

    view_feats = None
    if config.use_viewdirs and viewdirs is not None:
        vf = encode_views(viewdirs, config.i_embed_views,
                          config.multires_views)  # [R, D]
        if config.view_anneal_iters > 0 and step is not None:
            vf = vf * _ramp(step, config.view_anneal_iters)
        view_feats = vf[:, None, :].expand(r, s, vf.shape[-1]).reshape(r * s, -1)

    with record_function("mlp"):
        raw = params[mlp_name](feats, view_feats, config.torch_compute_dtype)
        sigma = torch.where(keep, raw[..., 3], 0.0)
        raw = torch.cat([raw[..., :3], sigma[..., None], raw[..., 4:]], dim=-1)
    return raw.reshape(r, s, -1)
