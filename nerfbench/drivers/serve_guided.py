"""Guided baked serving: ``serve.py``'s walk, seeded field and closed loop,
over the guided baked server (``program_guided.py``: the field baked at
``baked_res``^3 in set-up; each request a coarse pass at 1/``guided`` of
the resolution that bounds every ray's depth window, then 16 samples a
ray inside it), checked against the reference's own bake and guided
render (``reference/baked.py``, ``reference/guided.py``).

Traffic keys: those of ``serve_baked.py``, and ``guided`` (the coarse
pass's downsampling factor). While a run lasts, ``serve.py``'s server
builder, reference and trace are this file's; nothing of ``serve.py`` is
edited. A ``--trace 1`` run profiles ``trace_requests`` requests (no
encode runs in a baked request, so no encode count).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from nerfbench import program, program_guided, tracing
from nerfbench.drivers import serve
from nerfbench.drivers.serve_baked import _cameras
from nerfbench.reference import baked, guided
from nerfbench.reference.spec import FAR, NEAR, blender_bbox, make_spec


def run(ctx) -> Dict:
    args = dict(ctx.config["args"])
    args.update(ctx.traffic.get("flags", {}))
    finest = make_spec(args, blender_bbox(ctx.scene_dir)[:2]).finest_res
    res = min(int(ctx.traffic["baked_res"]), finest)
    g = int(ctx.traffic["guided"])
    cams = _cameras(ctx.scene_dir)

    def build(flags, width, height):
        return program_guided.serve_build(flags, width, height, res, g)

    def reference_maps(spec, make_field, poses, focal, W, H):
        params, _ = make_field()
        with torch.no_grad():
            snap = baked.bake(params, spec, cams, res)
        del params
        return [{k: v.cpu().numpy() for k, v in guided.render_image(
            snap, torch.as_tensor(np.asarray(p, np.float32)[:3, :4],
                                  device=snap["sigma"].device),
            H, W, focal, NEAR, FAR, spec, g=g).items()} for p in poses]

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
