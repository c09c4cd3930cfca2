"""CLI / config-file parsing of the port: the JAX package's parser, copied.

The port keeps its own copy of ``build_parser``, ``_read_config_file``,
``parse_args`` and ``FLAGSHIP_PRESET`` (it imports, reads and executes
nothing of ``indoor_nerf_tpu``): every flag of the JAX package's
``train/config.py`` with the same name, type and default, so the
``configs/*.txt`` files parse to the same values, plus ``--device``, the
one flag the port adds. ``tests/test_torch_config.py`` holds the two
parsers equal. Flags of features the port does not run yet are parsed here
and refused by ``train/trainer.py`` with the ROADMAP.md item that brings
them.

The ``key = value`` config format of the reference's ``configs/*.txt``
files is parsed directly: file values become defaults, CLI flags override
them, the precedence configargparse implements.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence


def _read_config_file(path: str) -> dict:
    """Parse a configargparse-style txt file: `key = value` lines, `#`
    comments. Returns {dest: string_value}."""
    values = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                raise ValueError(f"bad config line: {line!r}")
            key, val = line.split("=", 1)
            values[key.strip()] = val.strip()
    return values


def build_parser() -> argparse.ArgumentParser:
    """All reference flags (run_nerf.py:556-714), same names and defaults."""
    parser = argparse.ArgumentParser()
    add = parser.add_argument
    add("--config", type=str, default=None, help="config file path")
    add("--expname", type=str, help="experiment name")
    add("--basedir", type=str, default="./logs/", help="where to store ckpts and logs")
    add("--datadir", type=str, default="./data/llff/fern", help="input data directory")

    # training options
    add("--netdepth", type=int, default=8)
    add("--netwidth", type=int, default=256)
    add("--netdepth_fine", type=int, default=8)
    add("--netwidth_fine", type=int, default=256)
    add("--N_rand", type=int, default=32 * 32 * 4)
    add("--lrate", type=float, default=5e-4)
    add("--lrate_decay", type=int, default=250)
    add("--chunk", type=int, default=1024 * 32)
    add("--netchunk", type=int, default=1024 * 64)
    add("--no_batching", action="store_true")
    add("--no_reload", action="store_true")
    add("--ft_path", type=str, default=None)

    # rendering options
    add("--N_samples", type=int, default=64)
    add("--N_importance", type=int, default=0)
    add("--perturb", type=float, default=1.0)
    add("--use_viewdirs", action="store_true")
    add("--i_embed", type=int, default=1)
    add("--i_embed_views", type=int, default=2)
    add("--multires", type=int, default=10)
    add("--multires_views", type=int, default=4)
    add("--raw_noise_std", type=float, default=0.0)
    add("--render_only", action="store_true")
    add("--render_test", action="store_true")
    add("--render_factor", type=int, default=0)
    add("--render_fit_appearance", action="store_true",
        help="with --render_only --render_test: fit a per-view appearance "
             "latent on each test image's LEFT half and score the RIGHT "
             "half (NeRF-W half-image protocol, render/appearance.py) — "
             "for held-out views with unknown exposure")

    # precrop
    add("--precrop_iters", type=int, default=0)
    add("--precrop_frac", type=float, default=0.5)

    # dataset options
    add("--dataset_type", type=str, default="llff")
    add("--testskip", type=int, default=8)
    add("--shape", type=str, default="greek")  # deepvoxels
    add("--white_bkgd", action="store_true")
    add("--half_res", action="store_true")
    add("--scannet_sceneID", type=str, default="scene0000_00")
    add("--factor", type=int, default=8)  # llff
    add("--no_ndc", action="store_true")
    add("--lindisp", action="store_true")
    add("--spherify", action="store_true")
    add("--llffhold", type=int, default=8)

    # logging/saving
    add("--i_print", type=int, default=100)
    add("--i_img", type=int, default=500)
    add("--i_weights", type=int, default=10000)
    add("--i_testset", type=int, default=1000)
    add("--i_video", type=int, default=5000)

    # hash encoding
    add("--finest_res", type=int, default=512)
    add("--log2_hashmap_size", type=int, default=19)
    add("--n_levels", type=int, default=16,
        help="grid levels (reference hard-codes 16, hash_encoding.py:28). "
             "Extension: fewer levels x more features at equal parameter "
             "budget halve the (point, level) row count that bounds the "
             "TPU encode (BENCH_NOTES.md scatter-transaction wall)")
    add("--feats_per_level", type=int, default=2,
        help="features per grid level (reference hard-codes 2)")
    add("--freq_anneal_iters", type=int, default=0,
        help="FreeNeRF-style frequency annealing: ramp active grid levels "
             "linearly over this many steps (0 = off). Extension targeting "
             "few-shot radiance-ambiguity overfitting (models/field.py::"
             "level_anneal_weights)")
    add("--use_appearance", action="store_true",
        help="per-image appearance latents (NeRF-W-style, zero-init, "
             "added to the encoded view directions of each train "
             "image's rays). Extension for real captures with residual "
             "exposure/white-balance variation; eval renders use the "
             "unbiased encoding (models/field.py FieldConfig)")
    add("--view_anneal_iters", type=int, default=0,
        help="view-dependence annealing: scale encoded view-direction "
             "features by clip(step/iters, 0, 1) during training (0 = "
             "off). Extension targeting few-shot radiance ambiguity at "
             "the appearance level (models/field.py FieldConfig)")
    add("--sparse-loss-weight", type=float, default=1e-10, dest="sparse_loss_weight")
    add("--tv-loss-weight", type=float, default=1e-6, dest="tv_loss_weight")
    add("--distortion_loss_weight", type=float, default=0.0,
        help="Mip-NeRF 360 interval-distortion regularizer on the per-ray "
             "weight distribution (extension; combats few-shot floaters)")
    add("--table_decay_weight", type=float, default=0.0,
        help="fine-level grid amplitude decay: weight * sum_l 2^(l-L+1) * "
             "mean(table_l^2) added to the loss (extension; few-shot "
             "memorization lives in the finest grid levels)")
    add("--reg_views", type=int, default=0,
        help="unobserved-view patches per step for RegNeRF-style depth-"
             "smoothness regularization (0 = off). Novel poses are sampled "
             "from the training-camera hull on host "
             "(data/pipeline.py::UnobservedPatchSampler); extension "
             "targeting few-shot geometry overfitting")
    add("--reg_patch_size", type=int, default=8,
        help="side length of each unobserved-view patch (rays per patch = "
             "size^2)")
    add("--reg_depth_tv_weight", type=float, default=0.1,
        help="weight of the squared depth-TV loss on unobserved-view "
             "patches (active only when --reg_views > 0)")
    add("--reg_mode", type=str, default="tv", choices=["tv", "planar"],
        help="patch regularizer: 'tv' = RegNeRF first-difference depth "
             "smoothness; 'planar' = second differences of disparity "
             "(planes cost zero at any slant — indoor-targeted)")
    add("--reg_start_iter", type=int, default=0,
        help="iteration the patch regularizer activates at (in-jit gate)")
    add("--reg_pose_mode", type=str, default="novel",
        choices=["novel", "train"],
        help="patch pose source: 'novel' = unobserved poses from the "
             "camera hull (RegNeRF-style; measured destructive standalone "
             "— DIVERGENCES #34); 'train' = the training cameras "
             "themselves (classic monocular depth smoothness, "
             "photometrically opposed)")
    add("--ema_decay", type=float, default=0.0,
        help="Polyak EMA of params; eval renders then use the averaged "
             "weights (extension; measured NEUTRAL-NEGATIVE on the fast "
             "NeRF protocol — BENCH_NOTES.md — kept for long-horizon runs)")

    # quantization
    add("--use_quantization", action="store_true")
    add("--quantization_bits", type=int, default=8)

    # structural priors
    add("--use_structural_priors", action="store_true")
    add("--predict_normals", action="store_true")
    add("--depth_prior_weight", type=float, default=0.01)
    add("--planarity_weight", type=float, default=0.005)
    add("--manhattan_weight", type=float, default=0.002)
    add("--normal_consistency_weight", type=float, default=0.001)
    add("--structural_loss_start_iter", type=int, default=2000)
    add("--structural_loss_ramp_iters", type=int, default=1000)
    add("--overfitting_threshold", type=float, default=8.0)
    add("--min_structural_weight", type=float, default=0.0001)

    # A-CAQ
    add("--use_acaq", action="store_true")
    add("--target_metric", type=float, default=None)
    add("--bit_penalty", type=float, default=1e-3)
    add("--mdl_tolerance", type=float, default=1.0,
        help="MDL loss-inflation tolerance: bits shrink while quantized "
             "loss < tolerance * quant-bypassed loss. The reference "
             "hard-codes 1.2 (run_nerf.py:1216), which by the controller's "
             "band structure accepts ~1 dB of quantization cost; 1.0 "
             "targets ~0.2 dB. Must be >= 1.0 — the controller signal is "
             "clamped at 1.0, so lower values ratchet bits to max_bits "
             "(DIVERGENCES.md #35)")
    add("--acaq_start_iter", type=int, default=1000)

    # TPU-framework extensions (not in the reference)
    add("--use_occupancy", action="store_true",
        help="occupancy-grid guided sampling (NerfAcc-style): replaces the "
             "coarse+fine hierarchy with one pass over occupied space")
    add("--occ_resolution", type=int, default=64)
    add("--occ_samples", type=int, default=64,
        help="network samples per ray in occupancy mode")
    add("--occ_candidates", type=int, default=128)
    add("--occ_update_interval", type=int, default=16)
    add("--occ_weighting", type=str, default="density",
        choices=["density", "transmittance"],
        help="candidate weighting: raw grid density, or T*alpha "
             "compositing of the grid densities (concentrates samples on "
             "the visible surface; ops/occupancy.py)")
    add("--occ_mix", type=float, default=0.15,
        help="transmittance weighting's occlusion mix: fraction of the "
             "per-ray budget kept as density-style carving pressure "
             "(guards the measured fog lock-in; ops/occupancy.py)")
    add("--n_iters", type=int, default=8000,
        help="training iterations (reference hard-codes 8000, run_nerf.py:923)")
    add("--mesh_shape", type=str, default=None,
        help="process mesh as 'data' or 'data:4,model:2' (an axis without "
             "a size takes the rest); default = every process on data")
    add("--multihost", action="store_true",
        help="join torch.distributed, one process per card (NCCL; Gloo "
             "with --device cpu); each data rank samples N_rand/D rays")
    add("--coordinator_address", type=str, default=None,
        help="with --multihost: 'host:port' of the rendezvous, or "
             "'file:///path' of a file every process can reach (without it, "
             "torchrun's MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK)")
    add("--num_processes", type=int, default=None,
        help="with --multihost --coordinator_address: the world size")
    add("--process_id", type=int, default=None,
        help="with --multihost --coordinator_address: this process's rank")
    add("--seed", type=int, default=0, help="global PRNG seed")
    add("--precision", type=str, default="f32", choices=["f32", "bf16"],
        help="activation precision on TPU")
    add("--block_size", type=int, default=4, choices=[4, 3],
        help="block-hash tile: 4 -> 5^3-vertex tiles in 128 lanes (1 KB f32 "
             "rows); 3 -> 4^3-vertex tiles exactly filling 128 lanes with "
             "F=2 (512 B rows — half the HBM bytes per point-level)")
    add("--block_io", type=str, default="f32",
        choices=["f32", "bf16", "int8"],
        help="block-hash table HBM traffic precision (i_embed 3): bf16 "
             "halves the byte-bound row gather AND switches the encode "
             "backward to the fused bfloat16 cotangent scatter "
             "(ops/blockhash.py); int8 quarters the forward gather via "
             "per-level symmetric quantization with straight-through "
             "gradients (bf16 scatter backward); the table master and "
             "optimizer stay f32 in all modes")
    add("--ray_groups", type=str, default=None,
        help="block-hash gradient grouping (i_embed 3): comma list of "
             "per-level group sizes, coarsest first (e.g. "
             "'4,4,4,4,2,2,2,2,1,1,1,1,1,1,1,1'). Levels with group G>1 "
             "merge each G consecutive samples' backward cotangent rows "
             "into one anchor-tile row before the scatter — G-fold fewer "
             "rows in the row-transaction-bound encode backward. The "
             "forward features are always exact; the merge is exact "
             "while a group stays inside one partition block (the "
             "common case at coarse levels) and an anchor-attribution "
             "approximation otherwise. Not a faster setting on an NVIDIA "
             "H100: there the grouped step takes the time of the flat one "
             "(PERF.md). Mutually exclusive with --ray_strides")
    add("--ray_strides", type=str, default=None,
        help="block-hash ray-axis decimation (i_embed 3): comma list of "
             "per-level strides, coarsest first (e.g. "
             "'4,4,4,4,2,2,2,2,1,1,1,1,1,1,1,1'). Levels with stride k>1 "
             "encode only every k-th sample along each ray and lerp back "
             "— fewer scatter rows in the transaction-bound encode "
             "backward. Quality-neutral for coarse levels (their feature "
             "scale >> sample spacing)")
    add("--render_baked", action="store_true",
        help="with --render_only: bake the checkpoint (visibility-culled) "
             "and render through the deferred-shading snapshot — ~30x "
             "faster videos/testsets (docs/SERVING.md). Meant for "
             "CONVERGED checkpoints: on foggy early fields the bake's "
             "finer march integrates the fog differently than the "
             "training discretization")
    add("--render_baked_res", type=int, default=256,
        help="with --render_baked: bake grid resolution")
    add("--render_baked_geo_res", type=int, default=-1,
        help="with --render_baked: voxel-corner GEO table resolution "
             "(-1 = render_baked_res/2, the flagship default — measured "
             "quality-free and 8x smaller, serving_table_r4b.json; 0 = "
             "same as render_baked_res; any other divisor works)")
    add("--render_guided", type=int, default=4,
        help="with --render_baked: depth-guided coarse factor (0 = "
             "uniform 128-sample march)")
    add("--synthetic_variant", type=str, default="sphere",
        choices=["sphere", "room"],
        help="built-in procedural scene for --dataset_type synthetic: "
             "'sphere' (checker sphere on white) or 'room' (indoor "
             "Manhattan room for structural-prior experiments)")
    add("--synthetic_n_views", type=int, default=None,
        help="view count of the procedural scene (default 12)")
    add("--synthetic_res", type=int, default=None,
        help="image resolution of the procedural scene (default 64)")
    add("--synthetic_n_train", type=int, default=None,
        help="few-shot split: train-view count of the procedural room "
             "scene (default 80%%)")
    add("--use_pallas", action="store_true",
        help="use the fused Pallas hash-encode kernel where available")
    add("--profile_dir", type=str, default=None,
        help="write a torch.profiler trace of training steps start+10 .. "
             "start+210 into this dir")
    add("--debug_nans", action="store_true",
        help="torch.autograd anomaly detection, and a finiteness check of "
             "every step's outputs that raises at the first non-finite one")
    add("--flagship", action="store_true",
        help="apply the measured-fastest TPU training preset (i_embed 3 "
             "block-hash, block_size 3, bf16 table IO, occupancy-guided "
             "sampling, 8x4 level geometry — BENCH_NOTES.md flagship "
             "row). Any config-file/CLI value you set explicitly still "
             "wins. Parity behavior (exact NGP layout, i_embed 1) stays "
             "the default without this flag.")
    # The port's one flag of its own.
    add("--device", type=str, default="cuda",
        help="torch device the trainer and the server run on: 'cuda' (the "
             "current CUDA card, the default), 'cuda:N' or 'cpu'. A CUDA "
             "device that is not visible is an error; nothing switches to "
             "the CPU on its own")
    return parser


# The flagship training preset (--flagship / configs/*_tpu.txt): the JAX
# package's, value for value (BENCH_NOTES.md "block + occupancy + 4^3 tiles
# + bf16 IO" row). Values are DEFAULTS — config files and CLI flags
# override them.
FLAGSHIP_PRESET = {
    "i_embed": 3,
    "block_size": 3,
    "block_io": "bf16",
    "use_occupancy": True,
    "N_importance": 0,  # occupancy sampling replaces the hierarchical pass
    "occ_samples": 32,
    # T*alpha candidate weighting: concentrates the per-ray query budget on
    # the visible surface — beats the 48-sample density-weighted protocol
    # on both train and held-out PSNR with fewer samples
    # (convergence_tpu_transw32.json vs convergence_tpu_stratu.json).
    "occ_weighting": "transmittance",
    # 8 levels x 4 features at EQUAL float budget to 16x2: halves the
    # backward's (point, level) row count; held-out quality-neutral over 5
    # paired seeds (tpu_level_geometry_seeds.json).
    "n_levels": 8,
    "feats_per_level": 4,
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """configargparse semantics: config file sets defaults, CLI overrides."""
    parser = build_parser()
    args, _ = parser.parse_known_args(argv)
    if args.flagship:
        # Preset layer: weaker than config-file values, which are weaker
        # than explicit CLI flags (configargparse-style precedence).
        parser.set_defaults(**FLAGSHIP_PRESET)
    if args.config:
        file_values = _read_config_file(args.config)
        # Map file keys to parser actions; booleans in the file are words.
        str2bool = {"true": True, "false": False}
        defaults = {}
        for action in parser._actions:
            for key in (action.dest, *(o.lstrip("-") for o in action.option_strings)):
                if key in file_values:
                    raw = file_values[key]
                    if isinstance(action, argparse._StoreTrueAction):
                        defaults[action.dest] = str2bool.get(raw.lower(), bool(raw))
                    elif action.type is not None:
                        defaults[action.dest] = action.type(raw)
                    else:
                        defaults[action.dest] = raw
                    break
        if defaults.get("flagship"):
            # `flagship = True` INSIDE a config file: the preset still sits
            # below the file's own explicit values (preset < file < CLI).
            defaults = {**FLAGSHIP_PRESET, **defaults}
        parser.set_defaults(**defaults)
    return parser.parse_args(argv)
