"""The training entry point (train/trainer.py of the JAX package: the loop of
its ``train``) and the static config assembly that serving shares.

    python -m indoor_nerf_tpu_torch.run_nerf --config configs/lego_tpu.txt \
        --datadir DIR
    python -m indoor_nerf_tpu_torch.run_nerf --config configs/lego.txt \
        --datadir DIR
    python -m indoor_nerf_tpu_torch.train.trainer -- --flagship \
        --dataset_type synthetic --use_viewdirs --white_bkgd --n_iters 200

trains on the CUDA card (``--device cuda``, the default; the block-hash
encode then runs the hand-written ``tent_contract`` kernel, and its
backward ``table_scatter``, or ``group_scatter`` with ``--ray_groups``) or,
with ``--device cpu``, on the CPU. The parser's default encoder, the hash
grid (``--i_embed 1``, what the configs without ``_tpu`` run), and PE
(``--i_embed 0``, the classic NeRF MLP) are plain PyTorch, with the
hierarchical fine pass where ``--N_importance > 0``. With no card visible and no ``--device cpu``
it raises. Scenes come from ``data/load.py`` (blender, llff with NDC rays,
scannet, and the synthetic ones); rays from the shuffled pool of every
training ray, or with ``--no_batching`` one image per step
(``--precrop_iters``, ``--precrop_frac``). ``--ray_groups`` and
``--ray_strides`` (one value per level) select the ray-structured
encodes; ``--use_pallas`` the tile-interp route of the encode (a row gather
under autograd and the hand-written ``tile_interp`` kernels) where the JAX
package applies it: ``--block_size 4`` and ``--block_io f32``.

With ``--expname`` a run writes into ``<--basedir>/<mangle_expname(args)>/``
what the JAX trainer writes: ``args.txt``, ``config.txt``, checkpoints
``{step:06d}.ckpt`` every ``--i_weights`` steps and at the end (a later call
with the same flags resumes from the newest; ``--no_reload`` starts afresh,
``--ft_path`` names one file, which may be a checkpoint of the JAX
package), ``metrics/`` (``utils/metrics.py``), ``training_metrics.pkl`` and
``loss_vs_time.pkl`` every ``--i_print`` steps, ``testset_{step:06d}/``
every ``--i_testset`` steps (a figure and the PSNR of each held-out view,
``test_psnrs_avg*.pkl``; SSIM, GMSD and LPIPS where it has weights go to
the metrics; ``best.ckpt`` whenever the held-out PSNR is a new best) and
the render-path video every ``--i_video`` steps. ``--render_only`` renders
the render path (or, with ``--render_test``, the held-out views) from the
newest checkpoint into ``renderonly_{path|test}_{step:06d}/``, through the
baked renderer with ``--render_baked``. The expname is mangled with the
hyper-parameters, so a changed ``--lrate`` or ``--finest_res`` resolves to
a fresh directory. Without ``--expname`` nothing is written or resumed.

``--use_quantization`` trains the grid fields (``--i_embed 1`` or 3) with
A-CAQ's fake quantizers (``losses/quantization.py``; ``--quantization_bits``
to start from) and ``--use_acaq`` with the bitwidth controller from
``--acaq_start_iter`` on (``--bit_penalty``; MDL mode at
``--mdl_tolerance``, MGL mode with ``--target_metric``): every
``--i_print`` steps a ``[QUANT] Average bits`` line, the quantizer series
in the metrics and, at every ``--i_weights``, the model complexity and
``quantization_analysis.png``; test sets, videos and ``--render_only``
render the quantized field. ``--block_io int8`` rounds the block table's
gathered rows to 8 bits per level (straight-through, a bf16 scatter).

``--use_structural_priors`` (it switches ``--predict_normals`` on) adds
the Manhattan, planarity and consistency losses from
``--structural_loss_start_iter`` on, ramped over
``--structural_loss_ramp_iters``; every 500 steps after the first 500 of
them, a train PSNR more than ``--overfitting_threshold`` dB above the last
held-out PSNR multiplies the prior weights by 0.7 (not below
``--min_structural_weight``). ``--distortion_loss_weight``,
``--table_decay_weight``, ``--ema_decay`` (held-out renders then use the
params EMA), ``--freq_anneal_iters`` and ``--view_anneal_iters`` are the
step's other extensions (``train/step.py``, ``models/field.py``).

``--reg_views N`` adds N patches of ``--reg_patch_size``² rays from novel
poses (``--reg_pose_mode``) to every batch and their depth smoothness
(``--reg_mode``, ``--reg_depth_tv_weight``) to the loss from
``--reg_start_iter`` on; ``--use_appearance`` gives each image of the scene
a latent added to its rays' view features (held-out renders use none).
``--render_only --render_test --render_fit_appearance`` scores each
held-out view by the NeRF-W half-image protocol (``render/appearance.py``)
into ``fit_appearance.json``, then renders the test set.

``--multihost`` trains on several processes, one per card (NCCL; Gloo with
``--device cpu``), joined through ``torch.distributed``: with
``--coordinator_address host:port --num_processes N --process_id i``, or
under ``torchrun`` from its environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``; ``--device cuda`` becomes ``cuda:LOCAL_RANK``).
``--mesh_shape data:4,model:2`` lays the processes out on a data and a
model axis (``parallel/shard.py``; default, all on the data axis): each
data rank samples ``N_rand / D`` rays and ``reg_views / D`` patches from
``seed + 7919 * data_index``, the model axis shards the grid's table by
level (``parallel/tp.py``), the step is the global-view step of the
single-device one, and test sets and videos render through the sharded
renderer (``parallel/sp.py``). Every rank computes; only rank 0 writes,
and its checkpoints hold the gathered single-device state, which resumes
under any mesh and serves on one card.
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from indoor_nerf_tpu_torch import resolve_device
from indoor_nerf_tpu_torch.data.images import installed
from indoor_nerf_tpu_torch.data.load import SceneData, load_dataset
from indoor_nerf_tpu_torch.data.pipeline import (
    BatchedRaySampler,
    ImageRaySampler,
    UnobservedPatchSampler,
)
from indoor_nerf_tpu_torch.losses.quantization import QuantConfig, flat_bits
from indoor_nerf_tpu_torch.models.field import FieldConfig
from indoor_nerf_tpu_torch.ops.blockhash import BlockHashConfig
from indoor_nerf_tpu_torch.ops.encoding import HashGridConfig
from indoor_nerf_tpu_torch.ops.occupancy import OccupancyConfig
from indoor_nerf_tpu_torch.parallel.shard import (
    gather_state,
    make_mesh,
    make_sharded_train_step,
    parse_mesh_shape,
    shard_state,
)
from indoor_nerf_tpu_torch.render.path import render_path, write_video
from indoor_nerf_tpu_torch.render.renderer import RenderConfig
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.train.step import (
    TrainConfig,
    draw_step,
    eval_params,
    init_train_state,
    reg_active,
    train_step,
)
from indoor_nerf_tpu_torch.train.optim import named_leaves
from indoor_nerf_tpu_torch.utils.checkpoint import (
    maybe_resume,
    save_best_checkpoint,
    save_checkpoint,
)
from indoor_nerf_tpu_torch.utils.evaluation import ComprehensiveEvaluator
from indoor_nerf_tpu_torch.utils.metrics import MetricsLogger
from indoor_nerf_tpu_torch.utils.spans import span

PRIOR_KEYS = ("planarity", "manhattan", "normal_consistency", "depth_prior")
# The step's structural-prior diagnostics the [PRIOR] line prints.
PRIOR_DIAG = ("manhattan", "planarity", "normal_consistency",
              "semantic_floor_count", "semantic_wall_count",
              "wall_cluster_angle_deg")
# The flags ``train`` refuses for want of a port, each with the ROADMAP item
# that brings it: none since item 8 (multi-device).
_UNPORTED = ()
MILESTONES = (15, 20, 25, 30, 35)  # training PSNR, dB (JAX trainer.py:55)
PROFILE_FIRST, PROFILE_LAST = 10, 210  # --profile_dir: steps start + these


def _per_level(arg):
    """A comma list of per-level ints (``--ray_strides 4,4,2,1``) or None."""
    return tuple(int(v) for v in arg.split(",")) if arg else None


def _refuse(args, flags) -> None:
    for flag, default, item in flags:
        if getattr(args, flag, default) != default:
            raise NotImplementedError(f"--{flag} comes with ROADMAP.md {item}")


def mangle_expname(args) -> str:
    """The expname with the hyper-parameters appended (a copy of the JAX
    package's ``train/trainer.py::mangle_expname``; a test holds the two
    equal over every config file)."""
    expname = args.expname
    if args.i_embed == 1:
        expname += "_hashXYZ"
    elif args.i_embed == 0:
        expname += "_posXYZ"
    if args.i_embed_views == 2:
        expname += "_sphereVIEW"
    elif args.i_embed_views == 0:
        expname += "_posVIEW"
    expname += "_fine" + str(args.finest_res) + "_log2T" + str(args.log2_hashmap_size)
    expname += "_lr" + str(args.lrate) + "_decay" + str(args.lrate_decay)
    expname += "_RAdam"
    if args.sparse_loss_weight > 0:
        expname += "_sparse" + str(args.sparse_loss_weight)
    expname += "_TV" + str(args.tv_loss_weight)
    return expname


def logdir_of(args) -> Optional[str]:
    """Where a run of ``args`` keeps its checkpoints:
    ``basedir/mangle_expname(args)``, or None without ``--expname`` (the JAX
    package fails there with a TypeError; the port then writes and resumes
    no checkpoint, and ``train`` says so)."""
    if args.expname is None:
        return None
    return os.path.join(args.basedir, mangle_expname(args))


def resume(args, state: Dict, no_reload: bool) -> Dict:
    """``state`` restored from ``--ft_path`` or from the newest checkpoint of
    ``logdir_of(args)``, as ``maybe_resume`` rules; unchanged where there
    is neither."""
    logdir = logdir_of(args)
    if logdir is None and args.ft_path in (None, "None"):
        return state
    return maybe_resume(logdir or "", state, args.ft_path, no_reload)


def decay_prior_weights(args, i: int, psnr_list, last_test_psnr,
                        prior_weights: Dict[str, float]) -> bool:
    """The overfitting decay of the prior weights (JAX trainer.py:650-666),
    read at step ``i``: every 500 steps after the first 500 with the priors,
    once more than 50 training PSNRs are logged (``psnr_list``, one per
    ``--i_print``) and a test set was rendered, a mean of the last 20 that
    exceeds ``last_test_psnr`` by more than ``--overfitting_threshold``
    multiplies each weight by 0.7, not below ``--min_structural_weight``.
    Updates ``prior_weights`` in place; returns whether it decayed them."""
    if not (args.use_structural_priors
            and i > args.structural_loss_start_iter + 500
            and i % 500 == 0 and len(psnr_list) > 50
            and last_test_psnr is not None):
        return False
    recent_train = float(np.mean(psnr_list[-20:]))
    if recent_train - last_test_psnr <= args.overfitting_threshold:
        return False
    print(f"\n⚠️  Overfitting detected at iteration {i}")
    print(f"   Train PSNR: {recent_train:.1f} dB, "
          f"Last Test: {last_test_psnr:.1f} dB")
    for k in PRIOR_KEYS:
        prior_weights[k] = max(args.min_structural_weight,
                               prior_weights[k] * 0.7)
    print(f"   Reduced structural weights by 30%: {prior_weights}")
    return True


def enable_normals(args) -> None:
    """``--use_structural_priors`` switches ``--predict_normals`` on (the
    JAX trainer's switch, trainer.py:257-261); the server makes it too, so
    that it builds the nets the training run saved."""
    if args.use_structural_priors and not args.predict_normals:
        print("🔧 AUTOMATICALLY ENABLING NORMAL PREDICTION for structural priors")
        args.predict_normals = True


def build_train_config(args, scene: SceneData) -> TrainConfig:
    """Assemble the static config from CLI args + scene geometry (the JAX
    ``build_train_config``, for what the port runs)."""
    if args.use_occupancy and args.N_importance > 0:
        raise ValueError(
            f"--use_occupancy with --N_importance {args.N_importance}: the "
            "occupancy pass replaces the coarse+fine hierarchy, so pass "
            "--N_importance 0 (the JAX package fails on the pair: its step "
            "reads out[\"rgb0\"], which the occupancy branch of render_rays "
            "never returns)")
    if args.i_embed in (1, 3) and scene.bounding_box is None:
        raise ValueError(
            f"dataset {args.dataset_type} provides no bounding box; grid "
            "encodings (--i_embed 1/3) need one — use --i_embed 0")
    if args.use_occupancy and scene.bounding_box is None:
        raise ValueError("--use_occupancy needs a scene bounding box")
    if args.use_structural_priors and args.i_embed not in (1, 3):
        raise ValueError(
            "--use_structural_priors needs the normals of NeRFSmall, the "
            f"grid encoders' net (--i_embed 1 or 3; got {args.i_embed}): "
            "the classic NeRF MLP of PE predicts none (the JAX package "
            "fails on the pair with an IndexError when it traces the step)")
    if args.use_quantization and args.i_embed not in (1, 3):
        raise ValueError(
            "--use_quantization quantizes the grid encoders' table and "
            f"NeRFSmall (--i_embed 1 or 3; got {args.i_embed}): the JAX "
            "package fails on the pair (its init_train_state reads the "
            "grid's level count from a config that has no grid)")

    n_levels = args.n_levels
    feats_per_level = args.feats_per_level
    grid = block_grid = None
    if args.i_embed == 1:
        grid = HashGridConfig(
            bbox_min=scene.bounding_box[0],
            bbox_max=scene.bounding_box[1],
            n_levels=n_levels,
            n_features_per_level=feats_per_level,
            log2_hashmap_size=args.log2_hashmap_size,
            base_resolution=16,
            finest_resolution=args.finest_res,
        )
    elif args.i_embed == 3:
        # Capacity parity with the reference's 2^log2T-entry tables, at
        # equal float budget across (L, F) (JAX trainer.py:104-119).
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
            ray_strides=_per_level(args.ray_strides),
            ray_groups=_per_level(args.ray_groups),
            tile_interp=args.use_pallas,
        )
    if args.use_pallas:
        if block_grid is not None and block_grid.uses_tile_interp:
            print("[pallas] tile_interp kernel enabled (see BENCH_NOTES.md)")
        elif block_grid is not None and args.block_io == "int8":
            print("[pallas] --use_pallas with --block_io int8: the JAX int8 "
                  "encode contracts its dequantized rows with the tile_interp "
                  "kernel; the port contracts them with tent_contract, the "
                  "same function, and scatters as JAX does")
        else:
            print("[pallas] --use_pallas ignored: the tile_interp route "
                  "applies to --i_embed 3 at --block_size 4 with --block_io "
                  "f32 only, as in the JAX package (got i_embed "
                  f"{args.i_embed}, block_size {args.block_size}, block_io "
                  f"{args.block_io})")
    field = FieldConfig(
        grid=grid,
        block_grid=block_grid,
        i_embed=args.i_embed,
        i_embed_views=args.i_embed_views,
        multires=args.multires,
        multires_views=args.multires_views,
        use_viewdirs=args.use_viewdirs,
        predict_normals=args.predict_normals,
        n_importance=args.N_importance,
        netdepth=args.netdepth,
        netwidth=args.netwidth,
        netdepth_fine=args.netdepth_fine,
        netwidth_fine=args.netwidth_fine,
        compute_dtype="bfloat16" if args.precision == "bf16" else "float32",
        freq_anneal_iters=args.freq_anneal_iters,
        view_anneal_iters=args.view_anneal_iters,
        # One latent per image of the scene, train and held-out alike (JAX
        # trainer.py:161-163); they ride the view encoding.
        n_appearance=(len(scene.images)
                      if args.use_appearance and args.use_viewdirs else 0),
        use_quantization=args.use_quantization,
        quant=QuantConfig(init_bits=float(args.quantization_bits),
                          bit_penalty=args.bit_penalty,
                          target_metric=args.target_metric,
                          mdl_tolerance=args.mdl_tolerance),
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
        ndc=scene.ndc and not args.no_ndc,
        occupancy=occupancy,
        n_occ_samples=args.occ_samples,
    )
    return TrainConfig(
        render=render,
        near=scene.near,
        far=scene.far,
        ndc_hwf=((int(scene.hwf[0]), int(scene.hwf[1]), float(scene.hwf[2]))
                 if render.ndc else None),
        n_rand=args.N_rand,
        lrate=args.lrate,
        lrate_decay=args.lrate_decay,
        sparse_loss_weight=args.sparse_loss_weight,
        tv_loss_weight=args.tv_loss_weight,
        distortion_loss_weight=args.distortion_loss_weight,
        table_decay_weight=args.table_decay_weight,
        ema_decay=args.ema_decay,
        use_structural_priors=args.use_structural_priors,
        structural_loss_start_iter=args.structural_loss_start_iter,
        structural_loss_ramp_iters=args.structural_loss_ramp_iters,
        use_acaq=args.use_acaq,
        acaq_start_iter=args.acaq_start_iter,
        reg_patch_size=args.reg_patch_size,
        reg_depth_tv_weight=(args.reg_depth_tv_weight if args.reg_views > 0
                             else 0.0),
        reg_mode=args.reg_mode,
        reg_start_iter=args.reg_start_iter,
    )


def _quant_bits(flat: np.ndarray, n_embed: int) -> Dict[str, np.ndarray]:
    """The soft bitwidths as the logger takes them (JAX trainer.py:223),
    from ``flat_bits`` read on the host: ``embed`` (one per grid level) and
    ``network`` (the activations', then the weight's)."""
    return {"embed": flat[:n_embed], "network": flat[n_embed:]}


def make_sampler(args, scene: SceneData, cfg: TrainConfig, seed: int,
                 n_data: int = 1):
    """``(sample, skip)`` of the run's batches (JAX trainer.py:449-527), or
    of one data rank's share of them (``N_rand / n_data`` rays and
    ``reg_views / n_data`` patches):
    ``sample(i)`` is step i's batch of numpy arrays, those the step of
    ``cfg`` reads: ``rays_o``, ``rays_d``, ``target``, with
    ``--no_batching`` ``spatial_coords``, with the appearance latents
    ``img_idx`` and, while the patch smoothness weighs (``reg_active``),
    the patch rays ``reg_rays_o``/``reg_rays_d``. The rays come from the
    shuffled pool of every training ray or, with ``--no_batching``, from one
    image (``--precrop_iters``); the patches from ``UnobservedPatchSampler``
    (its seed ``seed + 13``), drawn whenever ``--reg_views`` is set, as
    JAX's. ``skip(i)`` makes step i's draws and, for the image sampler, no
    rays. ``sample`` is the ``sampler`` span."""
    H, W, _ = scene.hwf
    for flag in ("N_rand", "reg_views"):
        if getattr(args, flag) % n_data != 0:
            raise ValueError(f"--{flag} {getattr(args, flag)} must divide "
                             f"evenly over the {n_data} data ranks")
    n_rand = args.N_rand // n_data
    if args.no_batching:
        sampler = ImageRaySampler(
            scene.images, scene.poses, scene.i_train, H, W, scene.K,
            n_rand, precrop_iters=args.precrop_iters,
            precrop_frac=args.precrop_frac, seed=seed)
        sample, skip = sampler.next, sampler.skip
    else:
        sampler = BatchedRaySampler(scene.images, scene.poses, scene.i_train,
                                    H, W, scene.K, n_rand, seed=seed)
        sample = skip = lambda i: sampler.next()
    drop = set() if cfg.render.field.n_appearance > 0 else {"img_idx"}
    reg = None
    if args.reg_views > 0:
        reg = UnobservedPatchSampler(
            scene.poses[scene.i_train], H, W, scene.K,
            n_patches=args.reg_views // n_data, patch=args.reg_patch_size,
            seed=seed + 13,
            pose_mode=args.reg_pose_mode)
        if not reg_active(cfg, args.reg_views * args.reg_patch_size ** 2):
            drop |= {"reg_rays_o", "reg_rays_d"}

    def sample_batch(i):
        with span("sampler"):
            b = sample(i)
            if reg is not None:
                b.update(reg.next())
            return {k: v for k, v in b.items() if k not in drop}

    def skip_batch(i):
        skip(i)
        if reg is not None:
            reg.next()

    return sample_batch, skip_batch


def device_batch(sample, i: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Step ``i``'s batch of ``make_sampler``'s ``sample`` on ``device``,
    copied without blocking: the ``batch`` span."""
    with span("batch"):
        return {k: torch.from_numpy(v).to(device, non_blocking=True)
                for k, v in sample(i).items()}


def wait_read(done: Optional[torch.cuda.Event]) -> None:
    """Wait for a queued copy to the host to land (its CUDA event; None on
    the CPU, where the copy is done): the ``read`` span."""
    if done is not None:
        with span("read"):
            done.synchronize()


def one_batch(args, device, seed=None):
    """``(cfg, batch)`` for single steps of the CLI configuration ``args``:
    the static config ``train`` builds, and step 1's batch of
    ``make_sampler`` from ``seed`` (``args.seed`` by default) on
    ``device``."""
    enable_normals(args)
    scene = load_dataset(args)
    cfg = build_train_config(args, scene)
    sample, _ = make_sampler(args, scene, cfg,
                             args.seed if seed is None else seed)
    return cfg, {k: torch.from_numpy(v).to(device)
                 for k, v in sample(1).items()}


def _write_run_files(args, logdir: str) -> None:
    """``args.txt`` (every flag, with the mangled expname) and
    ``config.txt`` (a copy of ``--config``), as JAX trainer.py:278-285."""
    os.makedirs(logdir, exist_ok=True)
    values = dict(vars(args), expname=os.path.basename(logdir))
    with open(os.path.join(logdir, "args.txt"), "w") as f:
        for arg in sorted(values):
            f.write(f"{arg} = {values[arg]}\n")
    if args.config is not None:
        with open(args.config) as src, \
                open(os.path.join(logdir, "config.txt"), "w") as f:
            f.write(src.read())


def _render_only(args, scene: SceneData, cfg: TrainConfig, state: Dict,
                 logdir: Optional[str], mesh=None, is_main: bool = True
                 ) -> Dict:
    """``--render_only`` (JAX trainer.py:297-401): the render path, or with
    ``--render_test`` the held-out views against their images, from the
    state resumed, into ``renderonly_{path|test}_{step:06d}/`` with its
    video; through a bake of the field and the baked renderer with
    ``--render_baked``. With ``--render_test --render_fit_appearance``
    first the half-image protocol on each held-out view (``_fit_appearance``).
    Returns the step, the PSNRs, the directory and the video, and the
    fit's results under ``fit_appearance`` where it ran. With a ``mesh``
    of several ranks (``state`` whole on each) the views render through
    the sharded renderer and only rank 0 (``is_main``) writes."""
    start = int(state["step"])
    print("RENDER ONLY")
    if start == 0:
        print(
            "⚠️  render_only found NO checkpoint in "
            f"{logdir} — rendering from random init. The expname "
            "mangling encodes hyperparameters (lr/decay/res/...); pass "
            "the SAME flags as the training run, or use --ft_path."
        )
    gt = scene.images[scene.i_test] if args.render_test else None
    savedir = None
    if logdir is not None and is_main:
        savedir = os.path.join(logdir, "renderonly_{}_{:06d}".format(
            "test" if args.render_test else "path", start))
        os.makedirs(savedir, exist_ok=True)
    print("test poses shape", scene.render_poses.shape)
    fit = None
    if args.render_test and args.render_fit_appearance:
        fit = _fit_appearance(scene, cfg, state, savedir)
    image_renderer = None
    if args.render_baked:
        from indoor_nerf_tpu_torch.models.field import serving_params
        from indoor_nerf_tpu_torch.render.baked import (
            bake_field,
            make_baked_image_renderer,
        )
        from indoor_nerf_tpu_torch.serve import train_cameras

        Hb, Wb, _ = scene.hwf
        if args.render_factor != 0:
            Hb //= args.render_factor
            Wb //= args.render_factor
        print(f"[baked] baking at {args.render_baked_res}^3 ...")
        # The bake reads the unquantized params, as the JAX bake does.
        baked = bake_field(
            serving_params(eval_params(state), cfg.render.field),
            cfg.render.field, resolution=args.render_baked_res,
            train_cameras=train_cameras(scene),
            geo_resolution=args.render_baked_geo_res)
        g = args.render_guided
        image_renderer = make_baked_image_renderer(
            baked, int(Hb), int(Wb), n_samples=(16 if g else 128), guided=g,
            n_coarse=64)
    rgbs, _, psnrs = render_path(
        scene.render_poses, scene.hwf, scene.K, cfg.render.test_mode(),
        eval_params(state), scene.near, scene.far, gt_imgs=gt, savedir=savedir,
        render_factor=args.render_factor, occ_state=state["occ"],
        image_renderer=image_renderer, quant_state=state["quant"],
        mesh=mesh)
    print("Done rendering", savedir)
    video = (write_video(os.path.join(savedir, "video.mp4"), rgbs)
             if savedir is not None else None)
    out = {"step": start, "psnrs": psnrs, "savedir": savedir, "video": video}
    if fit is not None:
        out["fit_appearance"] = fit
    return out


def _fit_appearance(scene: SceneData, cfg: TrainConfig, state: Dict,
                    savedir: Optional[str]) -> Dict:
    """The NeRF-W half-image protocol on every held-out view (JAX
    trainer.py:319-349): a latent fitted on the left half of the view
    (``render/appearance.py``), the right half scored with the zero and the
    fitted latent, from the params (not their EMA) without quantizers, as
    JAX runs it. Prints the ``[fit-appearance]`` lines and writes
    ``fit_appearance.json`` into ``savedir`` with JAX's keys; returns its
    dict."""
    from indoor_nerf_tpu_torch.render.appearance import (
        eval_view_with_fitted_latent,
    )
    from indoor_nerf_tpu_torch.render.renderer import make_image_renderer

    H, W, _ = scene.hwf
    fit_render = make_image_renderer(cfg.render.test_mode(), int(H), int(W))
    rows = []
    for vi, i_test in enumerate(np.asarray(scene.i_test)):
        res = eval_view_with_fitted_latent(
            fit_render, state["params"], np.asarray(scene.poses)[i_test],
            scene.K, scene.near, scene.far, np.asarray(scene.images[i_test]),
            cfg.render, occ_state=state["occ"])
        rows.append(res)
        print(f"[fit-appearance] view {vi}: right-half PSNR zero "
              f"{res['psnr_right_zero']:.2f} -> fitted "
              f"{res['psnr_right_fitted']:.2f}")
    mean_fit = float(np.mean([r["psnr_right_fitted"] for r in rows]))
    mean_zero = float(np.mean([r["psnr_right_zero"] for r in rows]))
    print(f"[fit-appearance] mean right-half PSNR: zero {mean_zero:.2f} "
          f"fitted {mean_fit:.2f}")
    out = {"views": rows, "mean_zero": mean_zero, "mean_fitted": mean_fit}
    if savedir is not None:
        with open(os.path.join(savedir, "fit_appearance.json"), "w") as f:
            json.dump(out, f, indent=2)
    return out


def _check_finite(i: int, metrics: Dict, state: Dict) -> None:
    """``--debug_nans``: raise at the first non-finite loss or parameter
    after step ``i`` (the outputs of the step, read at once)."""
    outputs = {"loss": metrics["loss"], "img_loss": metrics["img_loss"]}
    outputs.update({f"params.{k}": v
                    for k, v in named_leaves(state["params"]).items()})
    for name, t in outputs.items():
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"--debug_nans: non-finite {name} after iteration {i}")


def init_multihost(args, device: torch.device) -> torch.device:
    """``--multihost``: join ``torch.distributed`` (JAX
    ``jax.distributed.initialize``, trainer.py:240-255) and return this
    process's device. The rendezvous is ``--coordinator_address host:port``
    (or ``file:///path``, a file rendezvous) with ``--num_processes`` and
    ``--process_id``, or, without them,
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). The backend is NCCL on a card and Gloo on
    the CPU; ``--device cuda`` becomes ``cuda:LOCAL_RANK`` (torchrun's, else
    the rank modulo the cards visible). A process group this process has
    already joined is kept if it is the same world."""
    if args.coordinator_address:
        if args.num_processes is None or args.process_id is None:
            raise ValueError("--multihost --coordinator_address needs "
                             "--num_processes and --process_id")
        addr = args.coordinator_address
        init_method = addr if addr.startswith("file://") else f"tcp://{addr}"
        world, rank = args.num_processes, args.process_id
    else:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                               "RANK") if k not in os.environ]
        if missing:
            raise ValueError(
                "--multihost needs --coordinator_address host:port, "
                "--num_processes and --process_id, or torchrun's "
                f"environment (missing {', '.join(missing)})")
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank(), dist.get_backend()) \
                != (world, rank, backend):
            raise RuntimeError(
                f"this process already joined rank {dist.get_rank()} of "
                f"{dist.get_world_size()} over {dist.get_backend()}")
    else:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank)
    print(f"[multihost] process {rank}/{world} backend={backend} "
          f"device={device}")
    return device


def train(args) -> Dict:
    """Train up to step ``args.n_iters`` (the loop of JAX trainer.py:234-866
    for what the port runs), or render with ``--render_only``.

    Resumes from the newest checkpoint of the run's directory (``resume``)
    and goes on from its step: the ray sampler and the generator of the
    draws are not part of a checkpoint, so both are advanced by the resumed
    step count (the draws of steps 1 .. step are made and dropped; the
    image sampler of ``--no_batching`` makes its draws and no rays). A
    resumed run therefore takes the batches and draws the uninterrupted run
    takes, also from a checkpoint of the JAX package.

    Each step's loss and PSNR are read one step late, as JAX reads them
    (:705-722), and logged as JAX logs them (:585-668): they are copied to
    the host without blocking as the step is queued, and read once the next
    step is queued, waiting only for the step they belong to (a blocking
    read would wait for the next step too); a step that prints, saves,
    renders or ends the run reads its own at once. On the card this read
    costs nothing that ten alternating rounds can resolve (``PERF.md`` §6,
    ``chip_smoke.py`` phase x). A non-finite loss saves the state of the
    newest step, named by its own step, and raises.
    ``--debug_nans`` turns on ``torch.autograd`` anomaly detection (which
    names the backward op that made a NaN, and the forward op behind it)
    and checks the loss and every parameter after each step, raising at the
    first non-finite one; JAX's ``jax_debug_nans`` instead re-runs the
    jitted step op by op and stops inside the forward at the op that made
    the NaN, and lets an inf pass.

    Returns the JAX trainer's ``time_metrics`` keys, and ``losses`` and
    ``psnrs`` per step taken, ``seconds`` of the step loop (closed by a
    device synchronize; ``eval_seconds`` of it went to the periodic saves,
    test sets and videos), ``load_seconds`` of the scene's loading, ``testsets`` (step,
    mean PSNR, SSIM, GMSD, the seconds of the render and of the metrics, per
    ``--i_testset`` evaluation), ``prior_weights`` (the base weights of the
    structural priors at the end) and ``prior_decays`` (step and weights of
    each overfitting decay), ``state`` (with a model axis this rank's
    shard: ``gather_state`` gives the whole), ``logdir`` and ``mesh``; with
    ``--render_only``, ``_render_only``'s dict. ``--multihost`` and
    ``--mesh_shape``: the module docstring."""
    _refuse(args, _UNPORTED)
    enable_normals(args)
    t_load = time.perf_counter()
    scene = load_dataset(args)
    load_seconds = time.perf_counter() - t_load
    print(f"[data] {args.dataset_type} scene of {len(scene.images)} "
          f"{scene.images.shape[1]}x{scene.images.shape[2]} views loaded in "
          f"{load_seconds:.2f} s")
    cfg = build_train_config(args, scene)
    device = resolve_device(args.device)
    if args.multihost:
        device = init_multihost(args, device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh(*parse_mesh_shape(args.mesh_shape, world))
    # Every rank computes (the collectives need all of them); only rank 0
    # writes (JAX trainer.py:268).
    is_main = mesh.is_main
    sharded = args.multihost or mesh.world_size > 1
    print(f"Device mesh: {mesh.shape}")
    logdir = logdir_of(args)
    if logdir is not None and is_main:
        _write_run_files(args, logdir)
    state = init_train_state(torch.Generator(device=device).manual_seed(args.seed),
                             cfg, device)
    state = resume(args, state, args.no_reload)
    eval_mesh = mesh if mesh.world_size > 1 else None
    if args.render_only:
        return _render_only(args, scene, cfg, state, logdir, eval_mesh,
                            is_main)
    state = shard_state(state, mesh)
    model_axis = "model" if mesh.size("model") > 1 else None
    if sharded:
        step_fn = make_sharded_train_step(cfg, mesh)
    else:
        def step_fn(st, batch, generator, prior_weights):
            return train_step(st, batch, cfg, generator,
                              prior_weights=prior_weights)

    def save(step_no: int) -> Optional[str]:
        """Every rank gathers the state; rank 0 writes it (the
        single-device format, whatever the mesh)."""
        full = gather_state(state, mesh)
        return save_checkpoint(logdir, step_no, full) if is_main else None

    start = int(state["step"])
    metrics_logger = MetricsLogger(
        args.basedir, os.path.basename(logdir or ""),
        dict(vars(args), expname=os.path.basename(logdir or "")),
        write=logdir is not None and is_main)
    evaluator = ComprehensiveEvaluator()
    test_config = cfg.render.test_mode()

    # The JAX trainer's per-step keys split from PRNGKey(seed + 1).
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    # Each data rank's own ray stream; the model ranks of one data shard
    # see the same rays.
    sample, skip = make_sampler(args, scene, cfg,
                                args.seed + 7919 * mesh.index("data"),
                                mesh.size("data"))
    n_reg = args.reg_views * args.reg_patch_size ** 2
    if args.reg_views > 0:
        print(f"[reg] unobserved-view depth TV: {args.reg_views} "
              f"patch(es)/step of {args.reg_patch_size}^2 rays, weight "
              f"{args.reg_depth_tv_weight}")
    t_replay = time.perf_counter()
    for s in range(start):
        skip(s + 1)
        draw_step(gen, cfg, s, args.N_rand, args.no_batching, n_reg)
    if start:
        print(f"replayed the sampler and the draws of {start} steps in "
              f"{time.perf_counter() - t_replay:.2f} s")
    n_steps = max(0, args.n_iters - start)
    print(f"training {n_steps} steps (from step {start}) of {args.N_rand} "
          f"rays on {device}; TRAIN views {scene.i_train.tolist()}, TEST "
          f"views {scene.i_test.tolist()}")
    if logdir is None:
        print("[TRAIN] no --expname: no checkpoint is written or resumed")
    elif args.i_video <= args.n_iters and not installed("imageio"):
        print("[video] imageio is not installed: videos are written as PNG "
              "frames (<name>_frames/)")

    loss_list, psnr_list, time_list = [], [], []  # at --i_print steps
    losses, psnrs, testsets = [], [], []  # every step; every test set
    best_test_psnr = -np.inf
    last_test_psnr: Optional[float] = None
    # The base weights of the structural priors, decayed on overfitting
    # (JAX trainer.py:550-555); the step ramps them.
    prior_weights = {
        "depth_prior": args.depth_prior_weight,
        "planarity": args.planarity_weight,
        "manhattan": args.manhattan_weight,
        "normal_consistency": args.normal_consistency_weight,
    }
    prior_decays = []  # (step, weights after the decay)
    time_metrics = {
        "start_time": time.time(),
        "structural_priors_start_time": None,
        "milestones": {},
        "convergence_time": None,
        "iterations_per_second": [],
        "iterations_per_second_steps": [],  # each rate's first and last step
        "time_to_milestones": {},
        "baseline_comparison": {
            "time_to_20db": None, "time_to_25db": None, "time_to_30db": None,
        },
    }
    time0 = time.time()
    # (step, time) of the last print step's loss read: a rate is the steps
    # over the seconds between two such reads, a print interval apart.
    last_print_read = (start, time.time())

    def queue_read(i: int, metrics: Dict):
        """Step ``i``'s loss and PSNR (and the priors' diagnostics on steps
        with the priors, and the quantizers' soft bits after the step) on
        their way to the host, and the event of their copy (None on the
        CPU). JAX reads the bits when it logs the step, one step later on
        the steps it does not flush (:705-722)."""
        keys = ["loss", "psnr"]
        if "structural_manhattan" in metrics:
            keys += [f"structural_{k}" for k in PRIOR_DIAG]
        vals = torch.stack([metrics[k].to(torch.float32) for k in keys])
        if state["quant"] is not None:
            vals = torch.cat([vals, flat_bits(state["quant"])])
        vals = vals.to("cpu", non_blocking=True)
        done = None
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return i, vals, done, metrics["lr"], len(keys)

    def process_metrics(pending) -> Tuple[float, float]:
        """JAX trainer.py:585-668 for a step queued by ``queue_read``.
        Returns its (loss, psnr)."""
        nonlocal last_print_read, last_bits
        i, vals, done, lr, n_keys = pending
        wait_read(done)
        loss, psnr, *diag = vals[:n_keys].tolist()
        if state["quant"] is not None:
            last_bits = _quant_bits(vals[n_keys:].numpy(), n_embed)
        now = time.time()
        if not np.isfinite(loss):
            saved = ("no checkpoint (no --expname)" if logdir is None else
                     f"state of step {state['step']} saved to "
                     f"{save(int(state['step']))}")
            raise FloatingPointError(
                f"non-finite loss {loss} at iteration {i}; {saved}. "
                "Re-run with --debug_nans to locate the op.")
        metrics_logger.log_iteration(i, now - time0, loss, psnr, lr,
                                     quantizer_bits=last_bits)
        if (diag and i % args.i_print == 0
                and i >= args.structural_loss_start_iter):
            m = dict(zip(PRIOR_DIAG, diag))
            print(f"[PRIOR] manhattan: {m['manhattan']:.4g} "
                  f"planarity: {m['planarity']:.4g} "
                  f"consistency: {m['normal_consistency']:.4g} "
                  f"floor/wall px: {int(m['semantic_floor_count'])}/"
                  f"{int(m['semantic_wall_count'])} "
                  f"wall-angle: {m['wall_cluster_angle_deg']:.1f} deg")
        losses.append(loss)
        psnrs.append(psnr)
        if args.i_print > 0 and i % args.i_print == 0:
            i0, t_prev = last_print_read
            if now > t_prev:
                time_metrics["iterations_per_second"].append(
                    (i - i0) / (now - t_prev))
                time_metrics["iterations_per_second_steps"].append([i0 + 1, i])
            last_print_read = (i, now)
        for milestone in MILESTONES:
            mkey = f"{milestone}db"
            if psnr >= milestone and mkey not in time_metrics["milestones"]:
                mt = now - time_metrics["start_time"]
                time_metrics["milestones"][mkey] = {
                    "iteration": i, "time_seconds": mt, "time_minutes": mt / 60.0,
                }
                bc = time_metrics["baseline_comparison"]
                if f"time_to_{milestone}db" in bc:
                    bc[f"time_to_{milestone}db"] = mt / 60.0
                print(f"🎯 MILESTONE: Reached {milestone} dB PSNR at iteration "
                      f"{i} ({mt/60:.2f} min)")
        if (i > 2000 and len(psnr_list) > 100
                and time_metrics["convergence_time"] is None):
            recent = psnr_list[-100:]
            if np.std(recent) < 0.5 and abs(recent[-1] - recent[0]) < 0.5:
                ct = now - time_metrics["start_time"]
                time_metrics["convergence_time"] = ct / 60.0
                print(f"📊 CONVERGENCE DETECTED at iteration {i} "
                      f"({ct/60:.1f} min)")
        if decay_prior_weights(args, i, psnr_list, last_test_psnr,
                               prior_weights):
            prior_decays.append((i, dict(prior_weights)))
        return loss, psnr

    # The quantizers' soft bits of the last step read (_quant_bits' dict).
    last_bits = None
    n_embed = (0 if state["quant"] is None
               else state["quant"]["embed"]["soft_bits"].shape[0])
    profiler = None
    eval_seconds = 0.0
    saved_at = start  # the state of a step that took none is its file's
    pending = None  # the last step queued and not read yet
    t0 = time.perf_counter()
    with torch.autograd.set_detect_anomaly(args.debug_nans):
        for i in range(start + 1, args.n_iters + 1):
            if args.profile_dir and i == start + PROFILE_FIRST:
                profiler = torch.profiler.profile(activities=(
                    [torch.profiler.ProfilerActivity.CPU]
                    + [torch.profiler.ProfilerActivity.CUDA]
                    * (device.type == "cuda")))
                profiler.start()
            batch = device_batch(sample, i, device)
            state, metrics = step_fn(state, batch, gen,
                                     prior_weights=prior_weights)
            if args.debug_nans:
                _check_finite(i, metrics, state)
            if profiler is not None and (i == start + PROFILE_LAST
                                         or i == args.n_iters):
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                profiler.stop()
                os.makedirs(args.profile_dir, exist_ok=True)
                trace = os.path.join(args.profile_dir, "trace.json")
                profiler.export_chrome_trace(trace)
                print(f"[profile] steps {start + PROFILE_FIRST}-{i} traced "
                      f"to {trace}")
                profiler = None

            if (args.use_structural_priors
                    and i == args.structural_loss_start_iter):
                # The activation banner (JAX trainer.py:677-687).
                time_metrics["structural_priors_start_time"] = time.time()
                t_act = (time_metrics["structural_priors_start_time"]
                         - time_metrics["start_time"])
                print("\n" + "=" * 80)
                print(f"🏗️  ACTIVATING STRUCTURAL PRIORS AT ITERATION {i}")
                print(f"   weights={prior_weights}  ramp="
                      f"{args.structural_loss_ramp_iters} iters  "
                      f"time-to-activation={t_act/60:.1f} min")
                print("=" * 80 + "\n")
            if (args.use_structural_priors
                    and i < args.structural_loss_start_iter
                    and i % args.i_print == 0
                    and i > args.structural_loss_start_iter - 500):
                remaining = args.structural_loss_start_iter - i
                print(f"  📊 Structural priors activate in {remaining} "
                      "iterations...")

            # Step i-1's metrics while step i runs (JAX trainer.py:705-722).
            if pending is not None:
                loss, psnr = process_metrics(pending)
            pending = queue_read(i, metrics)
            due = {name: every > 0 and i % every == 0 for name, every in (
                ("weights", args.i_weights), ("print", args.i_print),
                ("video", args.i_video), ("testset", args.i_testset))}
            if any(due.values()) or i == args.n_iters:
                loss, psnr = process_metrics(pending)
                pending = None
            t = time.time() - time0

            if due["weights"] and logdir is not None:
                t_eval = time.perf_counter()
                path = save(i)
                if is_main:
                    print("Saved checkpoints at", path)
                saved_at = i
                metrics_logger.save_checkpoint(i)
                metrics_logger.plot_training_curves()
                if args.use_quantization:
                    metrics_logger.calculate_model_complexity(
                        gather_state(state, mesh)["params"], last_bits)
                    metrics_logger.plot_quantization_analysis()
                eval_seconds += time.perf_counter() - t_eval

            if due["video"] and logdir is not None:
                t_eval = time.perf_counter()
                rgbs, disps, _ = render_path(
                    scene.render_poses, scene.hwf, scene.K, test_config,
                    eval_params(state), scene.near, scene.far,
                    occ_state=state["occ"], save_figures=False,
                    quant_state=state["quant"], mesh=eval_mesh,
                    model_axis=model_axis)
                print("Done, saving", rgbs.shape, disps.shape)
                moviebase = os.path.join(logdir, "{}_spiral_{:06d}_".format(
                    os.path.basename(logdir), i))
                if is_main:
                    write_video(moviebase + "rgb.mp4", rgbs)
                    write_video(moviebase + "disp.mp4",
                                disps / max(np.max(disps), 1e-8))
                eval_seconds += time.perf_counter() - t_eval

            if due["testset"] and len(scene.i_test) > 0:
                t_eval = time.perf_counter()
                testsavedir = None
                if logdir is not None and is_main:
                    testsavedir = os.path.join(logdir, f"testset_{i:06d}")
                    os.makedirs(testsavedir, exist_ok=True)
                print("test poses shape", scene.poses[scene.i_test].shape)
                rgbs, _, view_psnrs = render_path(
                    scene.poses[scene.i_test], scene.hwf, scene.K,
                    test_config, eval_params(state), scene.near, scene.far,
                    gt_imgs=scene.images[scene.i_test], savedir=testsavedir,
                    occ_state=state["occ"], quant_state=state["quant"],
                    mesh=eval_mesh, model_axis=model_axis)
                print("Saved test set")
                t_metrics = time.perf_counter()
                avg = sum(view_psnrs) / len(view_psnrs)
                last_test_psnr = avg
                evals = [evaluator.evaluate_image(r, g)
                         for r, g in zip(rgbs, scene.images[scene.i_test])]
                lpips_vals = [e["lpips"] for e in evals if "lpips" in e]
                ssim = float(np.mean([e["ssim"] for e in evals]))
                gmsd = float(np.mean([e["lpips_proxy"] for e in evals]))
                metrics_logger.log_test_metrics(
                    i, avg, ssim=ssim,
                    lpips=float(np.mean(lpips_vals)) if lpips_vals else None,
                    lpips_proxy=gmsd)
                print(f"Logged test PSNR: {avg:.2f}")
                if avg > best_test_psnr:
                    best_test_psnr = avg
                    if logdir is not None:
                        full = gather_state(state, mesh)
                        if is_main:
                            print(f"[best] new best held-out {avg:.2f} dB -> "
                                  f"{save_best_checkpoint(logdir, full)}")
                now = time.perf_counter()
                testsets.append({"step": i, "psnr": avg, "ssim": ssim,
                                 "gmsd": gmsd,
                                 "render_seconds": t_metrics - t_eval,
                                 "metrics_seconds": now - t_metrics})
                eval_seconds += now - t_eval

            if due["print"] or i == args.n_iters:
                print(f"[TRAIN] Iter: {i} Loss: {loss:.6f} PSNR: {psnr:.3f} "
                      f"lr: {metrics['lr']:.3e}")
                if last_bits is not None:
                    all_bits = np.concatenate([last_bits["embed"],
                                               last_bits["network"]])
                    print(f"[QUANT] Average bits: {np.mean(all_bits):.2f}, "
                          f"Num quantizers: {all_bits.size}")
            if due["print"]:
                loss_list.append(loss)
                psnr_list.append(psnr)
                time_list.append(t)
                if logdir is not None and is_main:
                    _write_training_pickles(args, logdir, loss_list,
                                            psnr_list, time_list, time_metrics,
                                            prior_weights)
                if i % 1000 == 0:
                    elapsed = (time.time() - time_metrics["start_time"]) / 60.0
                    ips = np.mean(time_metrics["iterations_per_second"][-100:])
                    print(f"\n📊 Time Efficiency Summary @ {i} iterations:")
                    print(f"   Total Time: {elapsed:.1f} minutes")
                    print(f"   Average Speed: {ips:.2f} it/s")
                    for mkey, data in time_metrics["milestones"].items():
                        print(f"     {mkey}: {data['time_minutes']:.2f} min "
                              f"(iter {data['iteration']})")
                    print()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    if n_steps:
        train_s = max(seconds - eval_seconds, 1e-9)
        print(f"{n_steps} steps in {seconds:.2f} s, {eval_seconds:.2f} s of "
              f"it in saves, test sets and videos ({n_steps / train_s:.2f} "
              f"steps/s, {n_steps * args.N_rand / train_s:.0f} rays/s "
              "without them)")
    final_step = int(state["step"])
    if logdir is not None:
        if saved_at != final_step:
            path = save(final_step)
            if is_main:
                print("Saved checkpoints at", path)
        metrics_logger.save_checkpoint(final_step)
        metrics_logger.plot_training_curves()
        if args.use_quantization:
            metrics_logger.plot_quantization_analysis()
    summary = metrics_logger.generate_summary_table()
    print("\n=== Training Summary ===")
    for row in summary:
        print("  ".join(f"{k}: {v}" for k, v in row.items()))
    return {**time_metrics, "losses": losses, "psnrs": psnrs,
            "seconds": seconds, "eval_seconds": eval_seconds,
            "load_seconds": load_seconds, "testsets": testsets,
            "prior_weights": prior_weights, "prior_decays": prior_decays,
            "state": state, "logdir": logdir, "mesh": mesh}


def _write_training_pickles(args, logdir, loss_list, psnr_list, time_list,
                            time_metrics, prior_weights) -> None:
    """``training_metrics.pkl`` and ``loss_vs_time.pkl`` with the JAX
    trainer's contents (:812-839; the structural-prior weights in use, after
    any overfitting decay)."""
    training_data = {
        "losses": loss_list,
        "psnr": psnr_list,
        "time": time_list,
        "time_metrics": time_metrics,
        "structural_priors_enabled": args.use_structural_priors,
        "config": {
            "depth_prior_weight": prior_weights["depth_prior"],
            "planarity_weight": prior_weights["planarity"],
            "manhattan_weight": prior_weights["manhattan"],
            "normal_consistency_weight": prior_weights["normal_consistency"],
            "structural_loss_start_iter": args.structural_loss_start_iter,
            "predict_normals": args.predict_normals,
        },
    }
    with open(os.path.join(logdir, "training_metrics.pkl"), "wb") as fp:
        pickle.dump(training_data, fp)
    with open(os.path.join(logdir, "loss_vs_time.pkl"), "wb") as fp:
        pickle.dump({"losses": loss_list, "psnr": psnr_list, "time": time_list},
                    fp)


def main(argv=None) -> Dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--":
        argv = argv[1:]
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
