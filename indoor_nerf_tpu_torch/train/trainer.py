"""Static config assembly (train/trainer.py::build_train_config of the JAX
package), for the block-hash and occupancy subset the serving slice runs."""

from __future__ import annotations

import dataclasses

import numpy as np

from indoor_nerf_tpu_torch.data.load import SceneData
from indoor_nerf_tpu_torch.models.field import FieldConfig
from indoor_nerf_tpu_torch.ops.blockhash import BlockHashConfig
from indoor_nerf_tpu_torch.ops.occupancy import OccupancyConfig
from indoor_nerf_tpu_torch.render.renderer import RenderConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The render config and scene bounds (the JAX TrainConfig's serving
    subset; the loss and optimizer fields come with the training slice)."""

    render: RenderConfig
    near: float = 2.0
    far: float = 6.0


# Flags whose non-default value changes the forward path, with the ROADMAP
# item that brings each.
_UNPORTED = (
    ("ray_strides", None, "item 6 (ray-structured encodes)"),
    ("ray_groups", None, "item 6 (ray-structured encodes)"),
    ("use_quantization", False, "item 5 (training extensions)"),
    ("predict_normals", False, "item 5 (training extensions)"),
)


def build_train_config(args, scene: SceneData) -> TrainConfig:
    """Assemble the static config from CLI args + scene geometry."""
    if args.i_embed != 3:
        raise NotImplementedError(
            f"--i_embed {args.i_embed}: the port runs the block-hash grid "
            "(--i_embed 3, e.g. --flagship); the others come with ROADMAP.md "
            "Queue 1 item 4 (the parity path)")
    for flag, default, item in _UNPORTED:
        if getattr(args, flag, default) != default:
            raise NotImplementedError(
                f"--{flag} comes with ROADMAP.md Queue 1 {item}")
    if scene.bounding_box is None:
        raise ValueError(f"dataset {args.dataset_type} provides no bounding "
                         "box; the block-hash grid needs one")
    if scene.ndc and not args.no_ndc:
        raise NotImplementedError(
            "NDC rays come with ROADMAP.md Queue 1 item 4 (the parity path)")

    n_levels = args.n_levels
    feats_per_level = args.feats_per_level
    # Capacity parity with the reference's 2^log2T-entry tables, at equal
    # float budget across (L, F) (JAX trainer.py:104-119).
    lf_shift = int(np.round(np.log2((n_levels * feats_per_level) / 32.0)))
    block_grid = BlockHashConfig(
        bbox_min=scene.bounding_box[0],
        bbox_max=scene.bounding_box[1],
        n_levels=n_levels,
        n_features_per_level=feats_per_level,
        log2_rows=max(4, args.log2_hashmap_size
                      - (7 if args.block_size == 4 else 6) - lf_shift),
        base_resolution=16,
        finest_resolution=args.finest_res,
        gather_dtype={"f32": "float32", "bf16": "bfloat16",
                      "int8": "int8"}[args.block_io],
        scatter_dtype=("bfloat16" if args.block_io in ("bf16", "int8")
                       else "float32"),
        block_size=args.block_size,
    )
    field = FieldConfig(
        block_grid=block_grid,
        i_embed=args.i_embed,
        i_embed_views=args.i_embed_views,
        use_viewdirs=args.use_viewdirs,
        n_importance=args.N_importance,
        compute_dtype="bfloat16" if args.precision == "bf16" else "float32",
    )
    occupancy = None
    if args.use_occupancy:
        occupancy = OccupancyConfig(
            bbox_min=scene.bounding_box[0],
            bbox_max=scene.bounding_box[1],
            resolution=args.occ_resolution,
            update_interval=args.occ_update_interval,
            n_candidates=args.occ_candidates,
            weighting=args.occ_weighting,
            occlusion_mix=args.occ_mix,
        )
    render = RenderConfig(
        field=field,
        n_samples=args.N_samples,
        n_importance=args.N_importance,
        perturb=args.perturb,
        lindisp=args.lindisp,
        white_bkgd=args.white_bkgd,
        raw_noise_std=args.raw_noise_std,
        ndc=False,
        occupancy=occupancy,
        n_occ_samples=args.occ_samples,
    )
    return TrainConfig(render=render, near=scene.near, far=scene.far)
