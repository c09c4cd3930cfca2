"""The sharded full-image renderer: the ray axis over every rank of the
mesh (``parallel/sp.py`` of the JAX package).

Rays are independent, and compositing is per ray, so an evaluation render
splits the image's flat ray axis into one contiguous share per rank
(a ``data:2 x model:2`` mesh renders four shares), renders its share in
tiles through the single-device tile loop (``render_ray_tiles``; the last
tile short, as the port's single-device renderer has it), and gathers the
maps over every rank, so every rank holds the whole image. With a
model-sharded table (the TP training layout, ``parallel/tp.py``) each rank
gathers the table once per call over the model axis and packs it once
(``serving_params``): a gather of the table per image, not an exchange of
features per tile.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from indoor_nerf_tpu_torch.models.field import params_device, serving_params
from indoor_nerf_tpu_torch.parallel.collectives import MODEL, gather_axis
from indoor_nerf_tpu_torch.render.renderer import (
    MAP_KEYS,
    RenderConfig,
    default_tile_rays,
    pose_rays,
    render_ray_tiles,
)


def _gather_world(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's equal-length share of a map, concatenated in rank
    order."""
    if mesh.world_group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.world_group)
    return torch.cat(parts)


def make_sharded_image_renderer(config: RenderConfig, H: int, W: int, mesh,
                                tile_rays: Optional[int] = None,
                                model_axis: Optional[str] = None):
    """A mesh-parallel full-image renderer (JAX ``make_sharded_image_
    renderer``, :28): ``render_fn(params, c2w, K, near, far[, quant_state,
    occ_state]) -> {rgb_map [H, W, 3], depth_map, acc_map, disp_map}`` on
    every rank. ``params`` are the training params (a master table; with
    ``model_axis``, this rank's level block of it, gathered here); every
    rank must call it. ``tile_rays=None`` sizes tiles from the card's
    memory (``default_tile_rays``)."""
    n = H * W
    per = -(-n // mesh.world_size)
    lo = min(n, mesh.rank * per)
    hi = min(n, lo + per)

    def render_fn(params, c2w, K, near, far, quant_state=None,
                  occ_state=None) -> Dict[str, torch.Tensor]:
        if model_axis is not None and mesh.size(MODEL) > 1:
            params = dict(params, table=gather_axis(
                params["table"].detach(), mesh, MODEL, 0))
        sp = serving_params(params, config.field, quant_state)
        dev = params_device(sp)
        tile = tile_rays or default_tile_rays(dev, config)
        c2w = torch.as_tensor(np.asarray(c2w, np.float32)[:3, :4], device=dev)
        K = torch.as_tensor(np.asarray(K, np.float32), device=dev)
        rays = pose_rays(c2w[None], K, H, W, float(near), float(far), config)
        local = [None if r is None else r[lo:hi] for r in rays]
        if hi > lo:
            flat = render_ray_tiles(sp, *local, config, tile, occ_state,
                                    quant_state)
        else:  # more ranks than rays: this rank's share is empty
            flat = {"rgb_map": rays[0].new_zeros((0, 3))}
            flat.update({k: rays[0].new_zeros((0,)) for k in MAP_KEYS[1:]})
        out = {}
        for k, v in flat.items():
            pad = v.new_zeros((per - v.shape[0],) + tuple(v.shape[1:]))
            out[k] = _gather_world(torch.cat([v, pad]), mesh)[:n]
        return {"rgb_map": out["rgb_map"].reshape(H, W, 3),
                **{k: out[k].reshape(H, W) for k in MAP_KEYS[1:]}}

    return render_fn
