"""Baked serving: ``serve.py``'s walk, seeded field and closed loop, over
the baked server (``program_baked.py``: the field baked at ``baked_res``^3
in set-up, then every request rendered from the snapshot), checked
against the reference's own bake and baked render
(``reference/baked.py``).

Traffic keys: those of ``serve.py``, and ``baked_res`` (the snapshot's
resolution, at most the field's finest grid resolution: vertices finer
than the grid's finest level add no detail). While a run lasts,
``serve.py``'s server builder, reference and trace are this file's;
nothing of ``serve.py`` is edited. A ``--trace 1`` run profiles
``trace_requests`` requests (no encode runs in a baked request, so no
encode count).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from nerfbench import program, program_baked, tracing
from nerfbench.drivers import serve
from nerfbench.reference import baked
from nerfbench.reference.spec import FAR, NEAR, blender_bbox, make_spec


def _cameras(scene_dir: str) -> Dict:
    """The training cameras the bake culls by: poses, focal, size, bounds."""
    with open(os.path.join(scene_dir, "transforms_train.json")) as f:
        meta = json.load(f)
    frame = meta["frames"][0]["file_path"]
    with open(os.path.join(scene_dir, "train",
                           os.path.basename(frame) + ".png"), "rb") as f:
        head = f.read(24)
    _, _, focal, W = blender_bbox(scene_dir)
    return {"poses": np.stack([np.asarray(fr["transform_matrix"], np.float32)
                               for fr in meta["frames"]]),
            "focal": focal, "W": W, "H": int.from_bytes(head[20:24], "big"),
            "near": NEAR, "far": FAR}


def run(ctx) -> Dict:
    args = dict(ctx.config["args"])
    args.update(ctx.traffic.get("flags", {}))
    finest = make_spec(args, blender_bbox(ctx.scene_dir)[:2]).finest_res
    res = min(int(ctx.traffic["baked_res"]), finest)
    cams = _cameras(ctx.scene_dir)

    def build(flags, width, height):
        return program_baked.serve_build(flags, width, height, res)

    def reference_maps(spec, make_field, poses, focal, W, H):
        params, _ = make_field()
        with torch.no_grad():
            snap = baked.bake(params, spec, cams, res)
        del params
        return [{k: v.cpu().numpy() for k, v in baked.render_image(
            snap, torch.as_tensor(np.asarray(p, np.float32)[:3, :4],
                                  device=snap["sigma"].device),
            H, W, focal, NEAR, FAR, spec=spec).items()} for p in poses]

    def trace(ctx, render_fn, poses, n0, spec, focal, W, H, make_field):
        m = int(ctx.traffic["trace_requests"])
        sel = [poses[(n0 + j) % len(poses)] for j in range(m)]

        def work():
            for p in sel:
                with serve.record_function("nerfbench.request"):
                    render_fn(p)

        wall = tracing.profiled(work, ctx.trace_path, ctx.device)
        return {"trace": dict(tracing.reduce_trace(ctx.trace_path),
                              wall_s=wall, units=m)}

    saved = (program.serve_build, serve.reference_maps, serve._trace)
    program.serve_build, serve.reference_maps, serve._trace = (
        build, reference_maps, trace)
    try:
        return serve.run(ctx)
    finally:
        program.serve_build, serve.reference_maps, serve._trace = saved

