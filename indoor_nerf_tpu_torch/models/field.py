"""The radiance field: block-hash encode + NeRFSmall + out-of-bbox masking.

Port of models/field.py of the JAX package for ``i_embed 3`` (the
block-hash grid, flat or ray-structured) without quantization, level/view
annealing, appearance latents or tensor parallelism. ``params`` is a dict:
``"table"`` (the ``[L*R, F*lpf]`` tensor) and ``"coarse"`` (a
``NeRFSmall``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from indoor_nerf_tpu_torch.models.mlp import init_nerf_small
from indoor_nerf_tpu_torch.ops.blockhash import (
    BlockHashConfig,
    block_hash_encode,
    block_hash_encode_grouped,
    block_hash_encode_strided,
    gather_table,
    init_block_table,
)
from indoor_nerf_tpu_torch.ops.encoding import sh_encode

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Static model configuration (the JAX FieldConfig's serving subset)."""

    block_grid: Optional[BlockHashConfig] = None
    i_embed: int = 3  # 3 = block-hash; 1 (hash grid) and 0 (PE) not ported
    i_embed_views: int = 2  # 2 = SH degree 4
    use_viewdirs: bool = True
    n_importance: int = 0
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    compute_dtype: str = "float32"  # or "bfloat16": MLP inputs rounded, f32 sums

    def __post_init__(self):
        if self.i_embed != 3:
            raise NotImplementedError(
                f"i_embed {self.i_embed}: the hash-grid and PE encoders come "
                "with ROADMAP.md Queue 1 item 4 (the parity path)")
        if self.use_viewdirs and self.i_embed_views != 2:
            raise NotImplementedError(
                "PE view encoding comes with ROADMAP.md Queue 1 item 4 "
                "(the parity path)")

    @property
    def input_ch(self) -> int:
        return self.block_grid.out_dim

    @property
    def input_ch_views(self) -> int:
        return 16 if self.use_viewdirs else 0  # SH degree 4

    @property
    def torch_compute_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else None


def init_field_params(generator: torch.Generator, config: FieldConfig,
                      device=None) -> Params:
    """Fresh params: the block table and the coarse NeRFSmall (the one net
    of the occupancy pass and of ``n_importance 0``; the fine net comes with
    the hierarchical pass, ROADMAP.md Queue 1 item 4).

    Same shapes and distributions as the JAX init; the numbers differ
    (torch.Generator is not jax.random), so parity tests bridge weights.
    The MLP weights are ``nn.Parameter``s; the table is a plain tensor
    until a train state marks every leaf trainable (``train/step.py``)."""
    return {
        "table": init_block_table(generator, config.block_grid, device),
        "coarse": init_nerf_small(
            generator, input_ch=config.input_ch,
            input_ch_views=config.input_ch_views,
            num_layers=config.num_layers, hidden_dim=config.hidden_dim,
            geo_feat_dim=config.geo_feat_dim,
            num_layers_color=config.num_layers_color,
            hidden_dim_color=config.hidden_dim_color, device=device),
    }


def serving_params(params: Params, config: FieldConfig) -> Params:
    """Params with the table packed and cast once as the row gather reads
    it (``gather_table``: vertex major, bf16 for the flagship). The JAX
    encode recasts the f32 master on every call; a server holds the table
    fixed, so it packs once. The copy is valid only while the params do not
    change: re-derive it after any update. It carries no gradient. The
    tile-interp route gathers whole rows of the master layout, so its table
    stays as it is."""
    out = dict(params)
    table = params["table"].detach()
    if not config.block_grid.uses_tile_interp:
        table = gather_table(table, config.block_grid)
    out["table"] = table
    return out


def encode_position(x: torch.Tensor, params: Params, config: FieldConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode flat ``[N, 3]`` positions -> (feats ``[N, L*F]``, keep_mask ``[N]``)."""
    return block_hash_encode(x, params["table"], config.block_grid)


def encode_views(dirs: torch.Tensor, config: FieldConfig) -> torch.Tensor:
    return sh_encode(dirs, degree=4)


def sigma_query(params: Params, mlp_name: str, pts: torch.Tensor,
                config: FieldConfig, with_geo: bool = False):
    """Density-only query ``[N]`` (encode + sigma net), zero outside the
    bbox. ``with_geo`` also returns the sigma net's geometry features
    ``[N, geo_feat_dim]`` (not masked), which the bake stores per vertex."""
    h, keep = encode_position(pts, params, config)
    sigma_net = params[mlp_name].sigma_net
    for l, layer in enumerate(sigma_net):
        h = h @ layer["w"]
        if l != len(sigma_net) - 1:
            h = torch.relu(h)
    sigma = torch.where(keep, h[..., 0], 0.0)
    return (sigma, h[..., 1:]) if with_geo else sigma


def query_field(params: Params, mlp_name: str, pts: torch.Tensor,
                viewdirs: Optional[torch.Tensor], config: FieldConfig
                ) -> torch.Tensor:
    """Query the field on an ``[R, S, 3]`` sample grid -> raw ``[R, S, 4]``.

    With ``ray_groups`` or ``ray_strides`` set on the block grid the encode
    is the ray-structured one (JAX field.py:519-546); else the flat one.
    ``viewdirs`` ``[R, 3]`` unit directions are encoded once per ray and
    broadcast over the samples. Sigma is zeroed outside the bbox."""
    r, s, _ = pts.shape
    bg = config.block_grid
    with record_function("encode"):
        if bg.ray_groups is not None or bg.ray_strides is not None:
            enc = (block_hash_encode_grouped if bg.ray_groups is not None
                   else block_hash_encode_strided)
            feats3, keep2 = enc(pts, params["table"], bg)
            feats, keep = feats3.reshape(r * s, -1), keep2.reshape(r * s)
        else:
            feats, keep = encode_position(pts.reshape(-1, 3), params, config)

    view_feats = None
    if config.use_viewdirs and viewdirs is not None:
        vf = encode_views(viewdirs, config)  # [R, D]
        view_feats = vf[:, None, :].expand(r, s, vf.shape[-1]).reshape(r * s, -1)

    with record_function("mlp"):
        raw = params[mlp_name](feats, view_feats, config.torch_compute_dtype)
        sigma = torch.where(keep, raw[..., 3], 0.0)
        raw = torch.cat([raw[..., :3], sigma[..., None]], dim=-1)
    return raw.reshape(r, s, -1)
