"""The radiance field: encoders + MLP + out-of-bbox masking
(models/field.py of the JAX package).

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

With ``n_appearance > 0`` (``--use_appearance``) the params hold a zero
``[n_appearance, input_ch_views]`` table ``"appearance"`` of per-image
latents (NeRF-W's appearance embedding, in view-feature space); a query's
``view_bias`` rows are added to the encoded view directions after the view
anneal. Evaluation passes none (the zero latent) or one fitted latent
(``render/appearance.py``).

With ``use_quantization`` (A-CAQ, ``losses/quantization.py``) the grid
encoders' queries take the quantizer state: the grid's table is
fake-quantized per level (``quantize_block_table``, ``quantize_hash_table``),
NeRFSmall's first sigma weight and its hidden sigma activations too, and a
training query returns the state its calibration updated. The table is
quantized before the gather; the gather selects entries, so this equals the
reference's quantization of the gathered features, and the hand-written
kernels of the encode run unchanged on the quantized table.

Nerfacto (``--nerfacto``, ``NerfactoConfig``): the field is the hash grid
on the contracted box [-2, 2]^3 with NeRFSmall, whose density is
``trunc_exp`` of the sigma net's first output and whose colour net reads
the SH of the direction, the geometry features and a per-image appearance
embedding ``params["embedding_appearance"]`` (its mean in evaluation;
``nerfacto_query``); two proposal density fields, each its own hash table
and a bias-free sigma net (``ProposalField``, ``proposal_density``), are
``params["proposal_0"]`` and ``params["proposal_1"]``.

Mip-NeRF 360 (``--mipnerf360``, ``MipNeRF360Config``): no grid; the
integrated positional encoding of each interval's Gaussian
(``ops/intervals.py``) feeds ``params["proposal_mlp"]``, one proposal MLP
for both proposal levels, and ``params["nerf_mlp"]``, the NeRF MLP
(``models/mlp.py::MipMLP``).

Inside a sharded step with a model axis (the active mesh of
``parallel/collectives.py::mesh_context``) the grid encodes go through the
level-sharded encode, as JAX ``encode_position`` routes them (:442-448):
``params["table"]`` is then this rank's level block, and a quantized field
quantizes its own levels and gathers the ``embed`` quantizer state of all
levels back (``_encode_position_tp``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from indoor_nerf_tpu_torch.losses.quantization import (
    QuantConfig,
    QuantState,
    calibrate,
    learned_fake_quant,
)
from torch import nn

from indoor_nerf_tpu_torch.models.mlp import (
    _linear,
    apply_nerf_big,
    init_linear,
    init_mip_mlp,
    init_nerf_big,
    init_nerf_small,
)
from indoor_nerf_tpu_torch.models.mlp_fused import (
    fused_applies,
    mask_sigma,
    nerf_small_fused,
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
    hash_grid_indices,
    hash_interp,
    init_hash_table,
    positional_encode,
    positional_encode_dim,
    sh_encode,
)
from indoor_nerf_tpu_torch.parallel.collectives import (
    MODEL,
    data_reduce_,
    gather_features,
    gather_levels,
)
from indoor_nerf_tpu_torch.parallel.tp import (
    current_block_tp,
    local_config,
    tp_block_encode,
    tp_hash_indices,
    tp_hash_interp,
)
from indoor_nerf_tpu_torch.utils.spans import span

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
    # A-CAQ fake quantization (grid fields only; the JAX package fails on it
    # with PE, and the trainer refuses the pair).
    use_quantization: bool = False
    quant: QuantConfig = QuantConfig()
    # Training schedules (0 = off): the grid levels fade in over
    # freq_anneal_iters steps, the view encoding over view_anneal_iters.
    freq_anneal_iters: int = 0
    view_anneal_iters: int = 0
    # Per-image appearance latents (0 = off): the rows of a zero
    # [n_appearance, input_ch_views] table, added to the encoded view
    # directions of each image's training rays.
    n_appearance: int = 0

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
    if config.n_appearance > 0 and config.use_viewdirs:
        params["appearance"] = torch.zeros(
            config.n_appearance, config.input_ch_views, device=device)
    return params


def params_device(params: Params) -> torch.device:
    """The device the params live on."""
    if "table" in params:
        return params["table"].device
    first = next(iter(params.values()))
    return first.device if torch.is_tensor(first) else next(
        first.parameters()).device


def serving_params(params: Params, config: FieldConfig,
                   quant_state: Optional[QuantState] = None) -> Params:
    """Params with the table packed and cast once as the row gather reads
    it (``gather_table``: vertex major, bf16 for the flagship, the int8
    gather's dequantized f32). The JAX encode recasts the f32 master on
    every call; a server holds the table fixed, so it packs once. The copy
    is valid only while the params do not change: re-derive it after any
    update. It carries no gradient. The tile-interp route gathers whole rows
    of the master layout, so its table stays as it is, and so does the hash
    grid's.

    With ``quant_state`` (a quantized field), the block table is packed
    from its evaluation-mode fake quantization (``quantize_block_table``:
    rounded bits, the levels the training calibrated): a function of the
    table and the state alone, which the JAX encode recomputes on every
    call. A packed table is therefore always the quantized one, and an
    evaluation query does not quantize it again; a 2-D table (the
    tile-interp route, the hash grid) is quantized by the query itself."""
    out = dict(params)
    if "table" not in params:
        return out
    table = params["table"].detach()
    if config.i_embed == 3 and not config.block_grid.uses_tile_interp:
        if config.use_quantization and quant_state is not None:
            table, _ = quantize_block_table(table, quant_state, config,
                                            train=False, step=None)
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


def _active(group: QuantState, config: FieldConfig, train: bool,
            step: Optional[int]):
    """The grid quantizer's gate: in training a host bool, ``step >=
    warmup_steps`` (the JAX ``lax`` select on the step, here a branch, as
    the host knows the step); in evaluation (no step) each level's
    ``calibrated`` flag, ``[L, 1]``."""
    if step is None:
        if train:
            raise ValueError("a training query passes its step (the grid "
                             "quantizer's warmup gate reads it)")
        return group["calibrated"][:, None]
    return step >= config.quant.warmup_steps


def _fake_quant_levels(t: torch.Tensor, bits: torch.Tensor,
                       range_scale: torch.Tensor, lvl_min: torch.Tensor,
                       train: bool) -> torch.Tensor:
    """Each row of ``t`` ``[L, n]`` quantized asymmetrically on its level's
    bits, range and minimum, and dequantized (no gradient): the arithmetic
    of the JAX ``_quantize_block_table`` / ``_quantize_corner_feats``
    (field.py:264-289, :355-371), with their three fixes (DIVERGENCES.md
    #37, #11): clip bounds at the scale's bitwidth (soft in training,
    rounded in evaluation), a multiplicative scale guard, and >= 24 bits
    passing through."""
    b = bits if train else torch.round(bits)
    qmin = torch.zeros_like(b)[:, None]
    qmax = (torch.exp2(b) - 1.0)[:, None]
    scale = torch.clamp_min(range_scale, 1e-8) / (torch.exp2(b) - 1.0)
    safe_scale = torch.clamp_min(scale, 1e-30)[:, None]
    zero_point = torch.round(torch.minimum(torch.maximum(
        -lvl_min[:, None] / safe_scale, qmin), qmax))
    x = t / safe_scale
    x += zero_point
    x = torch.minimum(torch.maximum(x.round_(), qmin), qmax)
    x -= zero_point
    x *= safe_scale
    return torch.where((bits >= 24.0)[:, None], t, x)


def quantize_block_table(table: torch.Tensor, quant_state: QuantState,
                         config: FieldConfig, train: bool,
                         step: Optional[int]
                         ) -> Tuple[torch.Tensor, QuantState]:
    """Per-level A-CAQ fake quantization of the block table ``[L*R,
    F*lpf]`` before the row gather (JAX ``_quantize_block_table``,
    field.py:301-385). The range is the level's live min and max over the
    whole level, padding lanes included, recomputed on every call; a
    training call records it in the ``embed`` group whether or not the
    warmup has passed. Active from ``warmup_steps`` in training (soft bits,
    straight-through: ``t + (dq - t).detach()``), and in evaluation on the
    levels the training calibrated (rounded bits). Returns (table, state)."""
    group = quant_state["embed"]
    L = config.block_grid.n_levels
    active = _active(group, config, train, step)
    t = table.reshape(L, -1)
    td = t.detach()
    lvl_min, lvl_max = torch.amin(td, dim=1), torch.amax(td, dim=1)
    if train:
        group = dict(group, running_min=lvl_min, running_max=lvl_max,
                     range_scale=lvl_max - lvl_min, v_max=lvl_max,
                     calibrated=group["calibrated"] | active)
        quant_state = dict(quant_state, embed=group)
    if active is False:
        return table, quant_state
    qc = config.quant
    bits = torch.clamp(group["soft_bits"], qc.min_bits, qc.max_bits)
    with torch.no_grad():
        dq = _fake_quant_levels(td, bits, lvl_max - lvl_min, lvl_min, train)
    q = t + (dq - td) if train else dq
    if active is not True:
        q = torch.where(active, q, t)
    return q.reshape(table.shape), quant_state


def quantize_hash_table(table: torch.Tensor, flat_idx: torch.Tensor,
                        quant_state: QuantState, config: FieldConfig,
                        train: bool, step: Optional[int]
                        ) -> Tuple[torch.Tensor, QuantState]:
    """Per-level A-CAQ fake quantization of the hash grid's gathered
    corner features (JAX ``_quantize_corner_feats``, field.py:213-298), as
    a quantization of the table ``[L*T, F]`` ahead of the fused gather and
    corner sum (``hash_interp``): the quantizer is elementwise for a fixed
    level, and level l's corner rows ``flat_idx[:, l]`` lie in its own rows
    ``[l*T, (l+1)*T)`` (``hash_grid_indices``), so the features equal the
    JAX ones. A training call from ``warmup_steps`` on takes each level's
    min and max over the corners ``flat_idx`` reads (the JAX min over the
    gathered ``[N, L, 8, F]``: the rows read, as a mask), expands the
    running range at once and shrinks it by an EMA of momentum 0.05, and
    quantizes with soft bits; before the warmup nothing changes. An
    evaluation call quantizes the calibrated levels with rounded bits on
    the recorded range. Returns (table, state)."""
    group = quant_state["embed"]
    g = config.grid
    L, F = g.n_levels, g.n_features_per_level
    active = _active(group, config, train, step)
    if active is False:
        return table, quant_state
    t = table.reshape(L, -1)
    td = t.detach()
    if train:
        with torch.no_grad():
            read = torch.zeros(table.shape[0], dtype=torch.bool,
                               device=table.device)
            read.index_fill_(0, flat_idx.reshape(-1).long(), True)
            # The rows the global batch reads, in a sharded step.
            read = data_reduce_(read.to(torch.uint8),
                                dist.ReduceOp.MAX).to(torch.bool)
            read = read.view(L, -1, 1)
            tl = td.view(L, -1, F)
            lvl_min = torch.amin(torch.where(read, tl, float("inf")), dim=(1, 2))
            lvl_max = torch.amax(torch.where(read, tl, float("-inf")),
                                 dim=(1, 2))
            m = 0.05
            done = group["calibrated"]
            ema_min = (1.0 - m) * group["running_min"] + m * lvl_min
            ema_max = (1.0 - m) * group["running_max"] + m * lvl_max
            new_min = torch.where(done, torch.minimum(ema_min, lvl_min), lvl_min)
            new_max = torch.where(done, torch.maximum(ema_max, lvl_max), lvl_max)
        group = dict(group, running_min=new_min, running_max=new_max,
                     range_scale=new_max - new_min, v_max=new_max,
                     calibrated=torch.ones_like(done))
        quant_state = dict(quant_state, embed=group)
    qc = config.quant
    bits = torch.clamp(group["soft_bits"], qc.min_bits, qc.max_bits)
    with torch.no_grad():
        dq = _fake_quant_levels(td, bits, group["range_scale"],
                                group["running_min"], train)
    q = t + (dq - td) if train else torch.where(active, dq, t)
    return q.reshape(table.shape), quant_state


def _quantizing(config: FieldConfig, quant_state: Optional[QuantState]) -> bool:
    return (config.use_quantization and quant_state is not None
            and config.uses_grid)


def _block_table(params: Params, config: FieldConfig,
                 quant_state: Optional[QuantState], train: bool,
                 step: Optional[int]) -> Tuple[torch.Tensor,
                                               Optional[QuantState]]:
    """The block table an encode reads, and the quantizer state: the master
    fake-quantized (``quantize_block_table``) for a quantized field; a
    packed copy as it is (``serving_params`` quantized it)."""
    table = params["table"]
    if _quantizing(config, quant_state) and table.dim() == 2:
        return quantize_block_table(table, quant_state, config, train, step)
    return table, quant_state


def encode_position(x: torch.Tensor, params: Params, config: FieldConfig,
                    quant_state: Optional[QuantState] = None,
                    train: bool = True, step: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[QuantState]]:
    """Encode flat ``[N, 3]`` positions -> (feats ``[N, input_ch]``,
    keep_mask ``[N]``, all True for PE; quant_state). With a quantized
    field and a ``quant_state`` the grid's table is fake-quantized first
    (``quantize_hash_table``; ``quantize_block_table`` on the master table
    ``[L*R, F*lpf]``, where a packed copy is already the quantized one,
    ``serving_params``)."""
    mesh = current_block_tp()
    if mesh is not None and config.uses_grid:
        return _encode_position_tp(x, params, config, quant_state, train,
                                   step, mesh)
    if config.i_embed == 1:
        table = params["table"]
        flat_idx, weights, keep = hash_grid_indices(x, config.grid)
        if _quantizing(config, quant_state):
            table, quant_state = quantize_hash_table(
                table, flat_idx, quant_state, config, train, step)
        return hash_interp(table, flat_idx, weights, config.grid), keep, \
            quant_state
    if config.i_embed == 3:
        table, quant_state = _block_table(params, config, quant_state, train,
                                          step)
        feats, keep = block_hash_encode(x, table, config.block_grid)
        return feats, keep, quant_state
    feats = positional_encode(x, config.multires)
    return feats, torch.ones(x.shape[0], dtype=torch.bool,
                             device=x.device), quant_state


def _encode_position_tp(x: torch.Tensor, params: Params, config: FieldConfig,
                        quant_state: Optional[QuantState], train: bool,
                        step: Optional[int], mesh
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   Optional[QuantState]]:
    """``encode_position`` of a grid field whose ``params["table"]`` is
    this model rank's level block: the quantizers of its levels (a local
    config of L/m levels and the slice of the ``embed`` group), the
    level-sharded encode (``tp_block_encode``; the hash grid's local corner
    sum, then the gather), and, where a training query updated the
    ``embed`` group, the group of all L levels gathered back, so every
    rank holds the replicated state of the single-device step."""
    j, m = mesh.index(MODEL), mesh.size(MODEL)
    grid = config.block_grid if config.i_embed == 3 else config.grid
    lp = grid.n_levels // m
    local = dataclasses.replace(
        config, **{"block_grid" if config.i_embed == 3 else "grid":
                   local_config(grid, m)})
    table = params["table"]
    quantizing = _quantizing(config, quant_state) and table.dim() == 2
    local_q = None
    if quantizing:
        local_q = dict(quant_state, embed={
            k: v[j * lp:(j + 1) * lp] for k, v in quant_state["embed"].items()})
    if config.i_embed == 3:
        if quantizing:
            table, local_q = quantize_block_table(table, local_q, local,
                                                  train, step)
        feats, keep = tp_block_encode(x, table, config.block_grid, mesh)
    else:
        idx, w, keep = tp_hash_indices(x, j, m, config.grid)
        if quantizing:
            table, local_q = quantize_hash_table(table, idx, local_q, local,
                                                 train, step)
        feats = gather_features(tp_hash_interp(table, idx, w), mesh)
    if quantizing and train:
        quant_state = dict(quant_state, embed={
            k: gather_levels(v, mesh) for k, v in local_q["embed"].items()})
    return feats, keep, quant_state


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
    bbox, without quantizers (the JAX ``sigma_query``, field.py:458-488):
    the grid refresh and the bake read the unquantized field. ``with_geo``
    also returns the sigma net's geometry features ``[N, geo_feat_dim]``
    (not masked), which the bake stores per vertex; grid fields only. For
    PE the whole NeRFBig runs, with the view encoding of zero directions
    (the JAX form)."""
    feats, keep, _ = encode_position(pts, params, config, None, False, None)
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


def _mlp_quantizers(params: Params, mlp_name: str, config: FieldConfig,
                    quant_state: QuantState, train: bool):
    """NeRFSmall's A-CAQ quantizers (JAX field.py:569-607): the first sigma
    weight's, calibrated symmetrically on it in a training call, and one
    per hidden sigma activation, each calibrated on its ``h`` in a
    training call and folded back into the state before it quantizes.
    Returns (weight_quant, act_quants, state): the state is a new dict
    that the activation quantizers update as the forward calls them."""
    qc = config.quant
    quant_state = dict(quant_state)
    if train:
        quant_state["weight"] = calibrate(
            quant_state["weight"], params[mlp_name].sigma_net[0]["w"],
            symmetric=True)
    act = dict(quant_state["act"])
    quant_state["act"] = act
    weight = quant_state["weight"]

    def weight_quant(w):
        return learned_fake_quant(w, weight, qc, symmetric=True, train=train)

    def make_act_quant(i):
        def act_quant(h):
            if train:
                new = calibrate({k: v[i] for k, v in act.items()}, h,
                                symmetric=False)
                for k, v in new.items():
                    act[k] = torch.cat([act[k][:i], v[None], act[k][i + 1:]])
            return learned_fake_quant(h, act, qc, symmetric=False,
                                      train=train, idx=i)
        return act_quant

    return (weight_quant, [make_act_quant(i)
                           for i in range(config.num_layers - 1)],
            quant_state)


def query_field(params: Params, mlp_name: str, pts: torch.Tensor,
                viewdirs: Optional[torch.Tensor], config: FieldConfig,
                step: Optional[int] = None,
                quant_state: Optional[QuantState] = None, train: bool = True,
                view_bias: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[QuantState]]:
    """Query the field on an ``[R, S, 3]`` sample grid -> (raw ``[R, S,
    C]``, quant_state) (C = 4, 7 with ``predict_normals``; 5 for a PE net
    without view head ahead of a fine pass).

    With ``ray_groups`` or ``ray_strides`` set on the block grid the encode
    is the ray-structured one (JAX field.py:519-546); else the flat one.
    ``viewdirs`` ``[R, 3]`` unit directions are encoded once per ray and
    broadcast over the samples; ``view_bias`` ``[R, D]`` (appearance
    latents) is added to them after the view anneal (JAX field.py:557-567).
    A training query (``step`` given) applies the level and view anneals.
    Sigma is zeroed outside the bbox; the
    normal channels are kept as they are. A query on the card without
    autograd outside a training step (``train`` False: serving,
    evaluation renders) runs the net and the mask in one kernel where
    ``mlp_fused.fused_applies`` says so, from the per-ray view features,
    with no broadcast copy of them.

    A quantized grid field with a ``quant_state`` fake-quantizes the table,
    NeRFSmall's first sigma weight and its hidden activations (``train``:
    soft bits and calibration, returning the updated state; else rounded
    bits and the state unchanged, JAX field.py:502-629). Without one every
    quantizer is bypassed, as the JAX step's MDL forward asks."""
    r, s, _ = pts.shape
    bg = config.block_grid
    with span("encode"):
        if config.i_embed == 3 and (bg.ray_groups is not None
                                    or bg.ray_strides is not None):
            table, quant_state = _block_table(params, config, quant_state,
                                              train, step)
            enc = (block_hash_encode_grouped if bg.ray_groups is not None
                   else block_hash_encode_strided)
            feats3, keep2 = enc(pts, table, bg)
            feats, keep = feats3.reshape(r * s, -1), keep2.reshape(r * s)
        else:
            feats, keep, quant_state = encode_position(
                pts.reshape(-1, 3), params, config, quant_state, train, step)
        feats = _apply_level_anneal(feats, config, step)

    vf = None
    if config.use_viewdirs and viewdirs is not None:
        vf = encode_views(viewdirs, config.i_embed_views,
                          config.multires_views)  # [R, D]
        if config.view_anneal_iters > 0 and step is not None:
            vf = vf * _ramp(step, config.view_anneal_iters)
        if view_bias is not None:
            vf = vf + view_bias

    net = params[mlp_name]
    if fused_applies(net, feats.device, torch.is_grad_enabled(), train,
                     config.torch_compute_dtype,
                     _quantizing(config, quant_state)):
        with span("mlp"):
            raw = nerf_small_fused(net, feats.contiguous(),
                                   None if vf is None else vf.contiguous(),
                                   s, keep.contiguous())
        return raw.reshape(r, s, -1), quant_state

    view_feats = None
    if vf is not None:
        view_feats = vf[:, None, :].expand(r, s, vf.shape[-1]).reshape(r * s, -1)
    with span("mlp"):
        quantizers = ()
        if _quantizing(config, quant_state):
            *quantizers, quant_state = _mlp_quantizers(
                params, mlp_name, config, quant_state, train)
        raw = mask_sigma(net(feats, view_feats, config.torch_compute_dtype,
                             *quantizers), keep)
    return raw.reshape(r, s, -1), quant_state


@dataclasses.dataclass(frozen=True)
class NerfactoConfig:
    """Nerfacto's proposal fields and sample counts (nerfstudio's
    ``NerfactoModelConfig`` defaults; the field itself is
    ``FieldConfig.grid`` on the contracted box). ``n_images``: the
    appearance embedding's rows, one per training image."""

    proposal_grids: Tuple[HashGridConfig, ...]
    proposal_samples: Tuple[int, ...] = (256, 96)
    nerf_samples: int = 48
    n_images: int = 1


# Nerfacto's fixed widths (nerfstudio's defaults): the proposal fields'
# hidden width and the appearance embedding's.
PROPOSAL_HIDDEN = 16
APPEARANCE_DIM = 32


class _TruncExp(torch.autograd.Function):
    """``exp`` whose backward multiplies by ``exp(min(x, 15))``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp_max(x, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """nerfacto's density activation: exp forward, a gradient capped at
    ``exp(15)``."""
    return _TruncExp.apply(x)


class ProposalField(nn.Module):
    """A proposal density field: a hash table ``[L * T, F]`` (``table``)
    and a bias-free sigma net ``L * F -> hidden -> 1`` (``sigma_net``)."""

    def __init__(self, table: torch.Tensor, sigma_net):
        super().__init__()
        self.table = nn.Parameter(table)
        self.sigma_net = nn.ModuleList(sigma_net)


def init_nerfacto_params(generator: torch.Generator, config: FieldConfig,
                         nc: NerfactoConfig, device=None) -> Params:
    """Fresh nerfacto params: the field's hash table, its NeRFSmall
    (``coarse``; the colour net's input 16 SH + geo + ``APPEARANCE_DIM``), the
    appearance embedding ``[n_images, APPEARANCE_DIM]`` ~ N(0, 1) (an
    ``nn.Embedding``'s init) and the proposal fields, each table ~
    U(-1e-4, 1e-4)."""
    params: Params = {
        "table": init_hash_table(generator, config.grid, device),
        "coarse": init_nerf_small(
            generator, input_ch=config.input_ch,
            input_ch_views=config.input_ch_views + APPEARANCE_DIM,
            num_layers=config.num_layers, hidden_dim=config.hidden_dim,
            geo_feat_dim=config.geo_feat_dim,
            num_layers_color=config.num_layers_color,
            hidden_dim_color=config.hidden_dim_color, device=device),
        "embedding_appearance": torch.randn(
            (nc.n_images, APPEARANCE_DIM), generator=generator, device=device),
    }
    for i, grid in enumerate(nc.proposal_grids):
        params[f"proposal_{i}"] = ProposalField(
            init_hash_table(generator, grid, device),
            [init_linear(generator, grid.out_dim, PROPOSAL_HIDDEN,
                         bias=False, device=device),
             init_linear(generator, PROPOSAL_HIDDEN, 1, bias=False,
                         device=device)])
    return params


def proposal_density(field: ProposalField, x: torch.Tensor,
                     grid: HashGridConfig,
                     compute_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """A proposal field's density ``[N]`` at contracted points ``x`` ``[N,
    3]`` (``trunc_exp``; zero outside the box)."""
    with span("encode"):
        idx, w, keep = hash_grid_indices(x, grid)
        feats = hash_interp(field.table, idx, w, grid)
    with span("mlp"):
        h = torch.relu(_linear(field.sigma_net[0], feats, compute_dtype))
        h = _linear(field.sigma_net[1], h, compute_dtype)
        return torch.where(keep, trunc_exp(h[:, 0]), 0.0)


def nerfacto_query(params: Params, x: torch.Tensor, viewdirs: torch.Tensor,
                   embedding: torch.Tensor, config: FieldConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nerfacto's field at contracted points ``x`` ``[R, S, 3]`` of rays
    with unit ``viewdirs`` ``[R, 3]`` and appearance ``embedding`` ``[R,
    E]``: (density ``[R, S]``, ``trunc_exp``, zero outside the box; rgb
    ``[R, S, 3]`` in [0, 1])."""
    r, s, _ = x.shape
    with span("encode"):
        feats, keep, _ = encode_position(x.reshape(-1, 3), params, config,
                                         None, False, None)
    views = encode_views(viewdirs, config.i_embed_views, config.multires_views)
    views = views[:, None, :].expand(r, s, views.shape[-1]).reshape(r * s, -1)
    extra = embedding[:, None, :].expand(r, s, embedding.shape[-1])
    with span("mlp"):
        raw = params["coarse"](feats, views, config.torch_compute_dtype,
                               input_extra=extra.reshape(r * s, -1))
        density = torch.where(keep, trunc_exp(raw[:, 3]), 0.0)
        rgb = torch.sigmoid(raw[:, :3])
    return density.reshape(r, s), rgb.reshape(r, s, 3)


@dataclasses.dataclass(frozen=True)
class MipNeRF360Config:
    """Mip-NeRF 360's sample counts and nets (multinerf ``configs/360.gin``
    and ``internal/models.py`` defaults): ``proposal_samples`` intervals a
    ray at each proposal level, ``nerf_samples`` at the NeRF level; the
    NeRF MLP ``netdepth`` x ``netwidth`` with its bottleneck and view
    layer, the proposal MLP ``prop_netdepth`` x ``prop_netwidth``; the IPE
    at degrees ``0 .. ipe_degrees - 1``, the direction's PE at ``0 ..
    view_degrees - 1``; ``pixel_radius``, a ray's base radius at unit
    depth, ``2 / sqrt(12)`` times the spacing of neighbouring pixels'
    directions (``1 / focal``)."""

    proposal_samples: Tuple[int, ...] = (64, 64)
    nerf_samples: int = 32
    netdepth: int = 8
    netwidth: int = 1024
    prop_netdepth: int = 4
    prop_netwidth: int = 256
    bottleneck_width: int = 256
    views_width: int = 128
    ipe_degrees: int = 12
    view_degrees: int = 4
    pixel_radius: float = 0.0

    @property
    def input_ch(self) -> int:
        return 6 * self.ipe_degrees

    @property
    def views_ch(self) -> int:
        return 3 + 6 * self.view_degrees


def pixel_radius(focal: float) -> float:
    """A camera ray's base radius at unit depth: ``2 / sqrt(12)`` of the
    distance between neighbouring pixels' directions, ``1 / focal`` on the
    port's rays (mip-NeRF's cone)."""
    return float(2.0 / np.sqrt(12.0) / focal)


def init_mipnerf360_params(generator: torch.Generator, mc: MipNeRF360Config,
                           device=None) -> Params:
    """Fresh Mip-NeRF 360 params: the proposal MLP (``proposal_mlp``), then
    the NeRF MLP (``nerf_mlp``), ``he_uniform`` weights and zero biases."""
    return {
        "proposal_mlp": init_mip_mlp(generator, mc.prop_netdepth,
                                     mc.prop_netwidth, mc.input_ch,
                                     device=device),
        "nerf_mlp": init_mip_mlp(generator, mc.netdepth, mc.netwidth,
                                 mc.input_ch,
                                 bottleneck_width=mc.bottleneck_width,
                                 views_width=mc.views_width,
                                 views_ch=mc.views_ch, device=device),
    }
