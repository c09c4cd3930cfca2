"""Online serving: one client, closed loop, no think time, as a viewer that
waits for each frame.

Traffic keys: ``width`` and ``height`` of a request, ``table_scale`` (the
served table's uniform half-width: a trained field's magnitude),
``walk`` (the camera walk's ranges), ``check_requests`` (how many
finished requests the reference renders again), ``trace_requests``
(profiled requests of a ``--trace 1`` run).

Set-up makes the served field from the seed (the benchmark's weights, and
its occupancy grid: the field's own density, ReLU, at each cell's centre;
``ctx.field``, where given, makes another), writes it as a checkpoint of
the port's format, and builds the server's render function on it with
``serve.build`` (one warm-up render inside).
The window sends the poses of a seeded walk through the room, one request
after another, for ``seconds``; a request's latency is the host time of
its ``render(c2w)``, which returns numpy maps and so is synchronized. A
seeded reservoir keeps ``check_requests`` of the finished requests' maps
for the reference.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from nerfbench import checks, counts, program, tracing
from nerfbench.reference import grid, model, render
from nerfbench.reference.spec import blender_bbox, make_spec
from nerfbench.scene import ROOM_SCALE, look_pose


def walk(seed: int, n: int, w: Dict) -> np.ndarray:
    """``[n, 3, 4]`` poses of a walk around the training ring: each step
    turns by U(turn) radians about the room's axis and draws the camera's
    radius, height, yaw offset and pitch (degrees) from their ranges."""
    rng = np.random.default_rng(seed)
    s = ROOM_SCALE
    theta = rng.uniform(0.0, 2 * np.pi)
    out = []
    for _ in range(n):
        theta += rng.uniform(*w["turn"])
        r = rng.uniform(*w["radius"]) * s
        h = rng.uniform(*w["height"]) * s
        pos = np.array([-r * np.cos(theta), -r * np.sin(theta), h])
        yaw = theta + np.radians(rng.uniform(*w["yaw_deg"]))
        out.append(look_pose(pos, yaw, np.radians(rng.uniform(*w["pitch_deg"]))))
    return np.stack(out)


@torch.no_grad()
def field_density(params, spec, dev, block: int = 1 << 16) -> torch.Tensor:
    """The field's density (ReLU; zero outside the box) at the centre of
    each occupancy cell."""
    g = spec.occ_resolution
    lo = torch.tensor(spec.bbox_min, device=dev)
    hi = torch.tensor(spec.bbox_max, device=dev)
    cells = torch.arange(g ** 3, device=dev)
    ijk = torch.stack([cells // (g * g), (cells // g) % g, cells % g], -1).float()
    pts = lo + (ijk + 0.5) / g * (hi - lo)
    out = []
    for s in range(0, pts.shape[0], block):
        feats, keep = grid.encode(pts[s:s + block], params["table"], spec)
        sig = model.sigma_only(params, spec.nets[-1], feats, spec)
        out.append(torch.relu(torch.where(keep, sig, 0.0)))
    return torch.cat(out)


def seeded_field(spec, seed: int, dev, table_scale: float):
    """The served weights from the seed and their occupancy grid."""
    params = model.make_params(spec, seed, dev, table_scale)
    # The served grid is an input: the benchmark makes it in float32.
    return params, field_density(params, dataclasses.replace(spec, tf32=False),
                                 dev)


# The port renders an image in tiles of this many rays; an 800x800 request
# is one full tile and a short one of 115,712 rays.
TILE_RAYS = 524_288


def _short_tile(maps: Dict, W: int) -> Dict:
    """The maps with the rays of the short last tile (past ``TILE_RAYS``;
    the last fifth of a smaller image) answered with the rays one image row
    earlier: a tile started at the wrong offset."""
    out = {}
    for k, v in maps.items():
        flat = np.array(v).reshape(-1, *np.shape(v)[2:])
        n = flat.shape[0]
        start = TILE_RAYS if n > TILE_RAYS else n - n // 5
        flat[start:] = flat[start - W:n - W].copy()
        out[k] = flat.reshape(np.shape(v))
    return out


def run(ctx) -> Dict:
    t = ctx.traffic
    dev = ctx.device
    args = dict(ctx.config["args"])
    args.update(t.get("flags", {}))
    t_weights = time.perf_counter()
    box = blender_bbox(ctx.scene_dir)
    spec = make_spec(args, box[:2])
    make_field = getattr(ctx, "field", None) or (
        lambda: seeded_field(spec, ctx.seed, dev, float(t["table_scale"])))
    params, density = make_field()
    os.makedirs(os.path.dirname(ctx.ckpt_path), exist_ok=True)
    program.write_checkpoint(ctx.ckpt_path, params, density, 8000)
    del params, density
    flags = program.cli_flags(args, {"datadir": ctx.scene_dir,
                                     "device": str(dev),
                                     "ft_path": ctx.ckpt_path})
    W, H = int(t["width"]), int(t["height"])
    t_build = time.perf_counter()
    render_fn, _, _ = program.serve_build(flags, W, H)
    print(f"setup: weights, grid and checkpoint {t_build - t_weights:.3f} s, "
          f"serve.build with its warm-up render "
          f"{time.perf_counter() - t_build:.3f} s", file=sys.stderr)
    poses = walk(ctx.seed, int(t["walk"]["poses"]), t["walk"])
    if ctx.fault == "stale_answer":
        inner = render_fn
        last = [inner(poses[-1])]

        def render_fn(c2w):
            # Each request answered with the previous request's maps (the
            # first with those of the walk's last pose).
            last.append(inner(c2w))
            del last[:-2]
            return last[0]
    elif ctx.fault == "short_tile":
        inner = render_fn

        def render_fn(c2w):
            maps, extra = inner(c2w)
            return _short_tile(maps, W), extra

    rng = np.random.default_rng(ctx.seed + 2)
    k = int(t["check_requests"])
    kept = []  # (index, pose, maps) of a uniform sample of finished requests
    lat = []
    failed = 0
    t_setup_end = time.perf_counter()
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < ctx.seconds:
        pose = poses[n % len(poses)]
        ts = time.perf_counter()
        try:
            with record_function("nerfbench.request"):
                maps, _ = render_fn(pose)
        except RuntimeError:
            failed += 1
            maps = None
        lat.append(time.perf_counter() - ts)
        if maps is not None:
            if len(kept) < k:
                kept.append((n, pose, maps))
            else:
                j = int(rng.integers(0, n + 1))
                if j < k:
                    kept[j] = (n, pose, maps)
        n += 1
    window_s = time.perf_counter() - t0
    lat_ms = np.asarray(lat) * 1e3
    out = {"setup_end": t_setup_end, "attempted": n, "failed": failed,
           "kind": "serve", "spec": spec, "traffic": t,
           "e2e": {"request_p50_ms": float(np.percentile(lat_ms, 50)),
                   "request_p95_ms": float(np.percentile(lat_ms, 95))},
           "window": {"seconds": window_s, "units": n,
                      "unit_wall_s": float(np.median(lat_ms)) * 1e-3}}
    focal = box[2] * (W / box[3])
    if ctx.trace:
        out.update(_trace(ctx, render_fn, poses, n, spec, focal, W, H,
                          make_field))
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)
    del render_fn
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_maps(spec, make_field, [p for _, p, _ in kept], focal,
                         W, H)
    print(f"check: the reference took {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    out["checks"] = checks.serve_numbers([m for _, _, m in kept], ref)
    if getattr(ctx, "control", False):
        low = reference_maps(dataclasses.replace(spec, tf32=True), make_field,
                             [p for _, p, _ in kept], focal, W, H)
        out["control_checks"] = checks.serve_numbers(
            [{"rgb_map": m["rgb"], "depth_map": m["depth"]} for m in low], ref)
    return out


def reference_maps(spec, make_field, poses, focal: float, W: int, H: int):
    """The reference's rgb and depth maps of ``poses`` on the field
    ``make_field()`` makes (``spec.tf32``: the control)."""
    params, density = make_field()
    dev = density.device
    return [{k: v.cpu().numpy() for k, v in render.render_image(
        params, torch.as_tensor(np.asarray(p, np.float32)[:3, :4], device=dev),
        H, W, focal, density, spec).items()} for p in poses]


def _trace(ctx, render_fn, poses, n0, spec, focal, W, H, make_field) -> Dict:
    """A profiled stretch of ``trace_requests`` requests, and the encode's
    least time per request from the first request's sample points."""
    m = int(ctx.traffic["trace_requests"])
    sel = [poses[(n0 + j) % len(poses)] for j in range(m)]

    def work():
        for p in sel:
            with record_function("nerfbench.request"):
                render_fn(p)

    wall = tracing.profiled(work, ctx.trace_path, ctx.device)
    red = tracing.reduce_trace(ctx.trace_path)
    params, density = make_field()
    ro, rd = render.image_rays(H, W, focal, torch.as_tensor(
        np.asarray(sel[0], np.float32)[:3, :4], device=ctx.device))
    seen = torch.zeros(grid.entry_count(spec), dtype=torch.bool,
                       device=ctx.device)
    n_pts = 0
    for s in range(0, ro.shape[0], 8192):
        for pts in render.sample_points(params, ro[s:s + 8192], rd[s:s + 8192],
                                        spec, density, None):
            grid.touched_entries(pts, spec, seen)
            n_pts += pts.shape[0]
    least = counts.least_seconds(counts.encode_work(n_pts, int(seen.sum()),
                                                    spec, False))
    return {"trace": dict(red, wall_s=wall, units=m),
            "work": {"encode_least_s": least,
                     "flops_per_unit": counts.request_flops(spec, W * H)}}
