"""Test-set and video rendering over a pose path, with the JAX package's
artifacts (render/path.py there; reference: PocketNeRF/run_nerf.py:154-215).

``render_path`` renders poses in blocks through ``_render_pose_block`` (or a
given whole-image renderer, e.g. the baked one), computes each view's PSNR
against its ground truth as JAX does and writes ``test_psnrs_avg{XX.XX}.pkl``.
Each view's figure is ``{i:03d}.png``: the rgb beside its depth in grey,
written with ``utils/png.py`` (the JAX package draws a matplotlib figure,
which the card's machine cannot). ``write_video`` writes an mp4 through
``imageio``, a GIF where it has no ffmpeg backend, and, where ``imageio``
itself is missing, the frames as ``<name>_frames/{i:03d}.png``.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from indoor_nerf_tpu_torch.models.field import params_device, serving_params
from indoor_nerf_tpu_torch.parallel.sp import make_sharded_image_renderer
from indoor_nerf_tpu_torch.render.renderer import (
    RenderConfig,
    _render_pose_block,
    default_tile_rays,
)
from indoor_nerf_tpu_torch.utils.png import encode_png, to8b

POSE_BLOCK = 4  # poses rendered together (JAX render_path's pose_block)


def view_figure(rgb: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """``[H, 2W, 3]`` uint8: the rgb beside the normalized depth in grey."""
    grey = np.repeat(to8b(depth)[..., None], 3, axis=-1)
    return np.concatenate([to8b(rgb), grey], axis=1)


def render_path(
    render_poses: np.ndarray,
    hwf,
    K: np.ndarray,
    config: RenderConfig,
    params,
    near: float,
    far: float,
    gt_imgs: Optional[np.ndarray] = None,
    savedir: Optional[str] = None,
    render_factor: int = 0,
    occ_state=None,
    tile_rays: Optional[int] = None,
    save_figures: bool = True,
    image_renderer=None,
    quant_state=None,
    mesh=None,
    model_axis: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray, List[float]]:
    """Render every pose; returns (rgbs, depths_normalized, psnrs).

    ``params`` are the field's (the table packed once here, as a server
    does); ``POSE_BLOCK`` poses go through the renderer together. A given
    ``image_renderer`` ``(c2ws [B, 3, 4], K, near, far) -> maps`` takes
    blocks of its own ``pose_block`` and must have been built for this
    (``render_factor``-scaled) H and W. The PSNR of a view is computed
    against ``gt_imgs`` at ``render_factor 0`` only, as in JAX. A quantized
    field renders with ``quant_state`` in evaluation mode (JAX
    render/path.py:38). With a ``mesh`` of more than one rank (every rank
    calls this) each pose is rendered by the sharded renderer
    (``parallel/sp.py``), the rays over every rank, the image on every
    rank, as JAX render/path.py:99-112; ``model_axis`` says that the
    params' table is level-sharded over it."""
    H, W, focal = hwf
    if render_factor != 0:
        H = H // render_factor
        W = W // render_factor
        focal = focal / render_factor
        K = np.array(
            [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float64
        )
    H, W = int(H), int(W)
    n_poses = len(render_poses)

    if image_renderer is not None:
        block = max(1, min(getattr(image_renderer, "pose_block", 1), n_poses))

        def render_block(c2ws):
            return image_renderer(c2ws, K, near, far)
    elif mesh is not None and mesh.world_size > 1:
        block = 1
        single = make_sharded_image_renderer(config, H, W, mesh, tile_rays,
                                             model_axis)

        def render_block(c2ws):
            out = single(params, c2ws[0], K, near, far, quant_state,
                         occ_state)
            return {k: v[None] for k, v in out.items()}
    else:
        block = max(1, min(POSE_BLOCK, n_poses))
        sp = serving_params(params, config.field, quant_state)
        dev = params_device(sp)
        tile = tile_rays or default_tile_rays(dev, config)
        K_t = torch.as_tensor(np.asarray(K, np.float32), device=dev)

        def render_block(c2ws):
            return _render_pose_block(
                sp, torch.as_tensor(c2ws, device=dev), K_t, float(near),
                float(far), config, H, W, tile, occ_state, quant_state)

    rgbs, depths, psnrs = [], [], []
    t = time.time()
    for start in range(0, n_poses, block):
        idxs = list(range(start, min(start + block, n_poses)))
        c2ws = np.stack([np.asarray(render_poses[j][:3, :4], np.float32)
                         for j in idxs])
        out = {k: v.float().cpu().numpy() for k, v in render_block(c2ws).items()
               if k in ("rgb_map", "depth_map")}
        for bi, i in enumerate(idxs):
            print(i, time.time() - t)
            t = time.time()
            rgb = out["rgb_map"][bi]
            depth = (out["depth_map"][bi] - near) / (far - near)
            rgbs.append(rgb)
            depths.append(depth)

            if gt_imgs is not None and render_factor == 0:
                gt = np.asarray(gt_imgs[i])
                p = -10.0 * np.log10(np.mean(np.square(rgb - gt)))
                print(p)
                psnrs.append(float(p))

            if savedir is not None and save_figures:
                with open(os.path.join(savedir, f"{i:03d}.png"), "wb") as f:
                    f.write(encode_png(view_figure(rgb, depth)))

    rgbs = np.stack(rgbs, 0)
    depths = np.stack(depths, 0)

    if gt_imgs is not None and render_factor == 0 and psnrs and savedir:
        avg_psnr = sum(psnrs) / len(psnrs)
        print("Avg PSNR over Test set: ", avg_psnr)
        with open(
            os.path.join(savedir, "test_psnrs_avg{:0.2f}.pkl".format(avg_psnr)),
            "wb",
        ) as fp:
            pickle.dump(psnrs, fp)

    return rgbs, depths, psnrs


def write_video(path: str, frames: np.ndarray, fps: int = 30,
                quality: int = 8) -> str:
    """Write ``frames`` (``[N, H, W(, 3)]`` in [0, 1]) as the mp4 ``path``
    through imageio (reference: run_nerf.py:1376-1377), as a GIF beside it
    where no ffmpeg backend is installed (JAX's fallback), and where imageio
    itself is missing as ``<path without .mp4>_frames/{i:03d}.png``.
    Returns what it wrote."""
    frames = to8b(frames)
    try:
        import imageio
    except ImportError:
        framedir = os.path.splitext(path)[0] + "_frames"
        os.makedirs(framedir, exist_ok=True)
        for i, frame in enumerate(frames):
            with open(os.path.join(framedir, f"{i:03d}.png"), "wb") as f:
                f.write(encode_png(frame))
        print(f"[video] imageio is not installed: {len(frames)} frames "
              f"written to {framedir}/")
        return framedir
    try:
        imageio.mimwrite(path, frames, fps=fps, quality=quality)
        return path
    except Exception as e:  # no ffmpeg/pyav backend
        gif_path = os.path.splitext(path)[0] + ".gif"
        print(f"[video] mp4 backend unavailable ({e}); writing {gif_path}")
        imageio.mimwrite(gif_path, frames, duration=1000.0 / fps, loop=0)
        return gif_path
