"""The training entry point (train/trainer.py of the JAX package, its
flagship subset) and the static config assembly that serving shares.

    python -m indoor_nerf_tpu_torch.train.trainer -- --flagship \
        --dataset_type synthetic --use_viewdirs --white_bkgd --n_iters 200

trains on the CUDA card (``--device cuda``, the default; the encode then
runs the hand-written ``tent_contract`` kernel, and its backward
``table_scatter``, or ``group_scatter`` with ``--ray_groups``) or, with
``--device cpu``, on the CPU, and prints loss and PSNR every ``--i_print``
steps. With no card visible and no ``--device cpu`` it raises.
``--ray_groups`` and ``--ray_strides`` (one value per level) select the
ray-structured encodes. ``--use_pallas`` selects the tile-interp route of
the encode (a row gather under autograd and the hand-written ``tile_interp``
kernels) where the JAX package applies it: ``--block_size 4`` and
``--block_io f32``, e.g.

    python -m indoor_nerf_tpu_torch.train.trainer -- --i_embed 3 \
        --use_pallas --use_occupancy --N_importance 0 --occ_samples 32 \
        --occ_weighting transmittance --dataset_type synthetic \
        --use_viewdirs --white_bkgd

Checkpoints go to ``<--basedir>/<mangle_expname(args)>/{step:06d}.ckpt``
every ``--i_weights`` steps and at the end; a later call with the same
flags resumes from the newest (``--no_reload`` starts afresh, ``--ft_path``
names one file, which may be a checkpoint of the JAX package). The expname
is mangled with the hyper-parameters, so a changed ``--lrate`` or
``--finest_res`` resolves to a fresh directory. Test renders, videos and
the metrics files come with ROADMAP.md Queue 1 item 3b: ``train`` names, in
one line before the loop, every flag of that item that was set and does
nothing.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from indoor_nerf_tpu_torch import resolve_device
from indoor_nerf_tpu_torch.data.load import SceneData, load_dataset
from indoor_nerf_tpu_torch.data.pipeline import BatchedRaySampler
from indoor_nerf_tpu_torch.models.field import FieldConfig
from indoor_nerf_tpu_torch.ops.blockhash import BlockHashConfig
from indoor_nerf_tpu_torch.ops.occupancy import OccupancyConfig
from indoor_nerf_tpu_torch.render.renderer import RenderConfig
from indoor_nerf_tpu_torch.train.config import build_parser, parse_args
from indoor_nerf_tpu_torch.train.step import (
    TrainConfig,
    draw_step,
    init_train_state,
    train_step,
)
from indoor_nerf_tpu_torch.utils.checkpoint import maybe_resume, save_checkpoint

_ITEM5 = "Queue 1 item 5 (training extensions)"
# Flags whose non-default value changes the model or the step, with the
# ROADMAP item that brings each.
_UNPORTED = (
    ("use_quantization", False, _ITEM5),
    ("use_acaq", False, _ITEM5),
    ("predict_normals", False, _ITEM5),
    ("use_structural_priors", False, _ITEM5),
    ("distortion_loss_weight", 0.0, _ITEM5),
    ("table_decay_weight", 0.0, _ITEM5),
    ("ema_decay", 0.0, _ITEM5),
    ("reg_views", 0, _ITEM5),
    ("use_appearance", False, _ITEM5),
    ("freq_anneal_iters", 0, _ITEM5),
    ("view_anneal_iters", 0, _ITEM5),
)
# Flags of the training loop only, refused by ``train``.
_ITEM3B = "Queue 1 item 3b (the rest of the training loop)"
_UNPORTED_LOOP = (
    ("no_batching", False, _ITEM3B),
    ("render_only", False, _ITEM3B),
    ("profile_dir", None, _ITEM3B),
    ("debug_nans", False, _ITEM3B),
    ("multihost", False, "Queue 1 item 8 (multi-device)"),
    ("mesh_shape", None, "Queue 1 item 8 (multi-device)"),
)
# Flags of the training loop that are parsed and have no effect yet: ``train``
# names those set away from the parser's default, with their item.
_IDLE_LOOP = (
    ("i_testset", _ITEM3B),
    ("i_video", _ITEM3B),
    ("i_img", _ITEM3B),
    ("render_factor", _ITEM3B),
)


def _per_level(arg):
    """A comma list of per-level ints (``--ray_strides 4,4,2,1``) or None."""
    return tuple(int(v) for v in arg.split(",")) if arg else None


def _refuse(args, flags) -> None:
    for flag, default, item in flags:
        if getattr(args, flag, default) != default:
            raise NotImplementedError(f"--{flag} comes with ROADMAP.md {item}")


def idle_loop_flags(args) -> Tuple[Tuple[str, str], ...]:
    """``(flag, ROADMAP item)`` for every flag of ``_IDLE_LOOP`` that
    ``args`` holds away from the parser's default."""
    defaults = build_parser()
    return tuple((flag, item) for flag, item in _IDLE_LOOP
                 if getattr(args, flag) != defaults.get_default(flag))


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


def build_train_config(args, scene: SceneData) -> TrainConfig:
    """Assemble the static config from CLI args + scene geometry."""
    if args.i_embed != 3:
        raise NotImplementedError(
            f"--i_embed {args.i_embed}: the port runs the block-hash grid "
            "(--i_embed 3, e.g. --flagship); the others come with ROADMAP.md "
            "Queue 1 item 4 (the parity path)")
    _refuse(args, _UNPORTED)
    if args.use_occupancy and args.N_importance > 0:
        raise ValueError(
            f"--use_occupancy with --N_importance {args.N_importance}: the "
            "occupancy pass replaces the coarse+fine hierarchy, so pass "
            "--N_importance 0 (the JAX package fails on the pair: its step "
            "reads out[\"rgb0\"], which the occupancy branch of render_rays "
            "never returns)")
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
        ray_strides=_per_level(args.ray_strides),
        ray_groups=_per_level(args.ray_groups),
        tile_interp=args.use_pallas,
    )
    if args.use_pallas:
        if block_grid.uses_tile_interp:
            print("[pallas] tile_interp kernel enabled (see BENCH_NOTES.md)")
        else:
            print("[pallas] --use_pallas ignored: the tile_interp route "
                  "applies at --block_size 4 with --block_io f32 only, as in "
                  f"the JAX package (got block_size {args.block_size}, "
                  f"block_io {args.block_io})")
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
    return TrainConfig(
        render=render,
        near=scene.near,
        far=scene.far,
        n_rand=args.N_rand,
        lrate=args.lrate,
        lrate_decay=args.lrate_decay,
        sparse_loss_weight=args.sparse_loss_weight,
        tv_loss_weight=args.tv_loss_weight,
    )


def one_batch(args, device, seed=None):
    """``(cfg, batch)`` for single steps of the CLI configuration ``args``:
    the static config ``train`` builds, and the first batch of the scene's
    training rays from ``seed`` (``args.seed`` by default) on ``device``."""
    scene = load_dataset(args)
    H, W, _ = scene.hwf
    cfg = build_train_config(args, scene)
    b = BatchedRaySampler(scene.images, scene.poses, scene.i_train, H, W,
                          scene.K, args.N_rand,
                          seed=args.seed if seed is None else seed).next()
    return cfg, {k: torch.from_numpy(b[k]).to(device)
                 for k in ("rays_o", "rays_d", "target")}


def train(args) -> Dict:
    """Train up to step ``args.n_iters`` on the batched ray sampler.

    Resumes from the newest checkpoint of the run's directory (``resume``)
    and goes on from its step: the ray sampler and the generator of the
    draws are not part of a checkpoint, so both are advanced by the resumed
    step count (the sampler's batches and ``draw_step``'s draws of steps 0
    .. step - 1 are made and dropped). A resumed run therefore takes the
    batches and draws the uninterrupted run takes, also from a checkpoint
    of the JAX package. Saves every ``--i_weights`` steps, at the end, and
    before raising on a non-finite loss.

    Returns {"losses": [...], "psnrs": [...] per step taken, "seconds" of
    the step loop (closed by a device synchronize), "state", "logdir"}."""
    _refuse(args, _UNPORTED_LOOP)
    scene = load_dataset(args)
    H, W, _ = scene.hwf
    cfg = build_train_config(args, scene)
    device = resolve_device(args.device)
    state = init_train_state(torch.Generator(device=device).manual_seed(args.seed),
                             cfg, device)
    logdir = logdir_of(args)
    state = resume(args, state, args.no_reload)
    start = int(state["step"])
    # The JAX trainer's per-step keys split from PRNGKey(seed + 1).
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    sampler = BatchedRaySampler(scene.images, scene.poses, scene.i_train, H, W,
                                scene.K, args.N_rand, seed=args.seed)
    for s in range(start):
        sampler.next()
        draw_step(gen, cfg, s, args.N_rand)
    n_steps = max(0, args.n_iters - start)
    print(f"training {n_steps} steps (from step {start}) of {args.N_rand} "
          f"rays on {device}; TRAIN views {scene.i_train.tolist()}")
    if logdir is None:
        print("[TRAIN] no --expname: no checkpoint is written or resumed")
    idle = idle_loop_flags(args)
    if idle:
        print("[TRAIN] set and without effect yet: "
              + ", ".join(f"--{flag} (ROADMAP.md {item})" for flag, item in idle))
    losses, psnrs = [], []
    saved_at = start  # the state of a step that took none is its file's
    t0 = time.perf_counter()
    for i in range(start + 1, args.n_iters + 1):
        b = sampler.next()
        batch = {k: torch.from_numpy(b[k]).to(device, non_blocking=True)
                 for k in ("rays_o", "rays_d", "target")}
        state, metrics = train_step(state, batch, cfg, gen)
        losses.append(metrics["loss"])
        psnrs.append(metrics["psnr"])
        if i % args.i_print == 0 or i == args.n_iters:
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                saved = ("no checkpoint (no --expname)" if logdir is None else
                         f"state saved to {save_checkpoint(logdir, i, state)}")
                raise FloatingPointError(
                    f"non-finite loss {loss} at iteration {i}; {saved}")
            print(f"[TRAIN] Iter: {i} Loss: {loss:.6f} "
                  f"PSNR: {float(metrics['psnr']):.3f} lr: {metrics['lr']:.3e}")
        if logdir is not None and args.i_weights > 0 and i % args.i_weights == 0:
            print("Saved checkpoints at", save_checkpoint(logdir, i, state))
            saved_at = i
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    if n_steps:
        print(f"{n_steps} steps in {seconds:.2f} s "
              f"({n_steps / seconds:.2f} steps/s, "
              f"{n_steps * args.N_rand / seconds:.0f} rays/s); test renders "
              "come with ROADMAP.md Queue 1 item 3b")
    if logdir is not None and saved_at != state["step"]:
        print("Saved checkpoints at",
              save_checkpoint(logdir, int(state["step"]), state))
    return {"losses": [float(v) for v in losses],
            "psnrs": [float(v) for v in psnrs],
            "seconds": seconds, "state": state, "logdir": logdir}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--":
        argv = argv[1:]
    train(parse_args(argv))


if __name__ == "__main__":
    main()
