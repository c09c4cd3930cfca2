"""Render server: novel views of the field over HTTP (port of scripts/serve.py).

  python -m indoor_nerf_tpu_torch.serve [--port 8000] [--width 800 --height 800] \\
      [--baked [--baked_res 256] [--snapshot FILE] [--guided 4]] \\
      -- --flagship --dataset_type synthetic --use_viewdirs --white_bkgd \\
         --expname demo --basedir /tmp/logs

Serves the newest checkpoint of the run the training flags name
(``basedir/mangle_expname``, or ``--ft_path``; the flags must match the
training run's, since the expname is mangled with them) and reports its step
in /health; with none it serves the seeded initial state and says so. A
field trained with normals (``--predict_normals``, which
``--use_structural_priors`` switches on) serves as the JAX server serves it:
the normals are computed and not served, and the bake leaves the normal net
out. The server renders the params, not their EMA, as the JAX server does.
A quantized field (``--use_quantization`` among the training flags) is
served online with the checkpoint's quantizers in evaluation mode (rounded
bits, the levels the training calibrated), as the JAX server renders it
(scripts/serve.py:128); ``--baked`` bakes the unquantized params, as the
JAX bake does.
Renders on the CUDA card (the block-hash encode then runs the hand-written
``tent_contract`` kernel; the hash grid and PE of the parity path are plain
PyTorch) unless the training flags hold ``--device cpu``;
with no card visible and no such flag it raises.

``--baked`` bakes the field into the deferred-shading snapshot
(``render/baked.py``) at start-up and serves from it; with ``--snapshot FILE``
it loads FILE if it exists, else bakes and saves it there. ``--guided G``
renders two levels: a 1/G-resolution pass bounds each ray's depth interval,
then 16 samples per ray inside it (128 unguided). A failed bake or snapshot
load is an error; the server never switches to online rendering by itself.

API:
  GET  /health              -> {"status": "ok", "step": N, "resolution": [H, W]}
  POST /render              body: {"c2w": [[...3x4...]], "format": "png"}
                            -> image/png (or .npy of the rgb map with "npy")
  GET  /render?theta=..&phi=..&radius=..   spherical orbit shortcut
A /render answer carries its request id in an ``X-Request-Id`` header: the
id on the request's spans (``utils/spans.py``).
"""

from __future__ import annotations

import argparse
import io
import itertools
import json
import os
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from indoor_nerf_tpu_torch import resolve_device
from indoor_nerf_tpu_torch.data.load import load_dataset
from indoor_nerf_tpu_torch.data.poses import pose_spherical
from indoor_nerf_tpu_torch.models.field import serving_params
from indoor_nerf_tpu_torch.render.baked import (
    bake_field,
    default_baked_tile_rays,
    load_baked,
    make_baked_image_renderer,
    save_baked,
)
from indoor_nerf_tpu_torch.render.renderer import (
    MAP_KEYS,
    default_tile_rays,
    make_image_renderer,
)
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.train.step import init_train_state
from indoor_nerf_tpu_torch.train.trainer import (
    build_train_config,
    enable_normals,
    logdir_of,
    resume,
)
from indoor_nerf_tpu_torch.utils.png import encode_png
from indoor_nerf_tpu_torch.utils.spans import span


def train_cameras(scene) -> dict:
    """The training views as ``bake_field``'s visibility culling takes them."""
    Ht, Wt = int(scene.hwf[0]), int(scene.hwf[1])
    Kt = np.array([[scene.hwf[2], 0, 0.5 * Wt], [0, scene.hwf[2], 0.5 * Ht],
                   [0, 0, 1]], np.float32)
    return {"poses": np.asarray(scene.poses)[scene.i_train][:, :3, :4],
            "K": scene.K if scene.K is not None else Kt, "H": Ht, "W": Wt,
            "near": scene.near, "far": scene.far}


def _baked_snapshot(args, params, field_cfg, scene, device):
    """The ``--baked`` snapshot: loaded from ``--snapshot`` if that file
    exists, else baked from ``params`` with the training cameras for
    visibility culling (and saved to ``--snapshot`` if given)."""
    snap = getattr(args, "snapshot", None)
    if snap and os.path.exists(snap):
        baked = load_baked(snap, device)
        print(f"loaded snapshot {snap}")
        return baked
    res = getattr(args, "baked_res", 256)
    print(f"baking snapshot at {res}^3 ...")
    t0 = time.perf_counter()
    baked = bake_field(params, field_cfg, resolution=res,
                       table_dtype=getattr(args, "baked_dtype", "bfloat16"),
                       train_cameras=train_cameras(scene),
                       geo_resolution=getattr(args, "baked_geo_res", -1))
    print(f"baked in {time.perf_counter() - t0:.1f}s")
    if snap:
        save_baked(snap, baked)
        print(f"saved snapshot to {snap}")
    return baked


def maps_to_host(out, device) -> dict:
    """The maps ``MAP_KEYS`` of ``out`` as numpy arrays of their own.

    From the card each map is copied straight into page-locked memory
    (PyTorch's caching host allocator: a block goes back to its cache when
    the caller drops the array, and the next request reuses it), so the
    copy is one DMA at the link's speed. A pageable copy stages through a
    host buffer and takes the host's cores with it, and its time follows
    whatever else the host does; in a fresh process it also faults in new
    pages, request after request."""
    if device.type != "cuda":
        return {k: out[k].cpu().numpy() for k in MAP_KEYS}
    host = {}
    for k in MAP_KEYS:
        host[k] = torch.empty(out[k].shape, dtype=out[k].dtype,
                              pin_memory=True)
        host[k].copy_(out[k], non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    return {k: v.numpy() for k, v in host.items()}


def build(args):
    """Set up the field and renderer. Returns ``(render, step, (H, W))``;
    ``render(c2w, request_id=None) -> (maps, seconds)`` with numpy
    rgb/depth/acc/disp maps. A render is one ``request`` span (the unit of
    ``utils/spans.py``) tagged with its request id (the next of
    ``render.request_ids`` unless given) over ``queue`` (waiting for the
    card's lock), ``render`` (queueing the tiles), ``drain`` (the device
    finishing) and ``copy`` (the maps into numpy)."""
    train_args = list(args.train_args)
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    cli = parse_args(train_args)
    enable_normals(cli)
    scene = load_dataset(cli)
    cfg = build_train_config(cli, scene)
    device = resolve_device(cli.device)
    gen = torch.Generator(device=device).manual_seed(cli.seed)
    field_cfg = cfg.render.field
    state = resume(cli, init_train_state(gen, cfg, device), no_reload=False)
    step = int(state["step"])
    if step == 0:
        print("⚠️  serving an UNTRAINED model (no checkpoint found in "
              f"{logdir_of(cli)}; seeded initial state, seed {cli.seed})")
    # Serving holds the params fixed, so the packed gather copy of the table
    # is made once here, from the RESTORED table (valid while these params
    # are served unchanged), fake-quantized first for a quantized field.
    quant, occ = state["quant"], state["occ"]
    chain = cfg.render.chain
    if getattr(args, "baked", False) and chain is not None:
        raise ValueError(f"--baked with --{chain.name}: the bake reads the "
                         "block-hash and hash-grid fields, not a proposal "
                         "chain; serve it online")
    if getattr(args, "baked", False):
        # The bake reads the unquantized params, as the JAX bake does.
        params = serving_params(state["params"], field_cfg)
    else:
        params = serving_params(state["params"], field_cfg, quant)
    del state  # the RAdam moments and the f32 master are not served

    H = int(args.height or scene.hwf[0])
    W = int(args.width or scene.hwf[1])
    focal = scene.hwf[2] * (W / scene.hwf[1])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    if getattr(args, "baked", False):
        baked = _baked_snapshot(args, params, field_cfg, scene, device)
        g = getattr(args, "guided", 0)
        # Tiles sized once, from the memory free after the bake, as the
        # online server sizes them: sized per request, they followed the
        # allocator's cache from one request to the next.
        tile = default_baked_tile_rays(baked, 64 if g else 128, 4)
        renderer = make_baked_image_renderer(
            baked, H, W, tile_rays=tile, n_samples=(16 if g else 128),
            guided=g, n_coarse=64, white_bkgd=cfg.render.white_bkgd)
        print(f"rendering {H}x{W} on {device} from the baked snapshot in "
              f"tiles of {tile} rays"
              + (f", guided by a 1/{g} pass" if g else ""))

        def render_maps(c2w):
            return renderer(c2w, K, scene.near, scene.far)
    else:
        tile = default_tile_rays(device, cfg.render)
        print(f"rendering {H}x{W} on {device} in tiles of {tile} rays")
        online = make_image_renderer(cfg.render.test_mode(), H, W, tile)

        def render_maps(c2w):
            return online(params, c2w, K, scene.near, scene.far, occ, quant)

    lock = threading.Lock()  # one render at a time on the card
    request_ids = itertools.count(1)

    def render(c2w, request_id=None):
        rid = next(request_ids) if request_id is None else request_id
        with span("request", request=rid):
            with span("queue"):
                lock.acquire()
            try:
                t0 = time.perf_counter()
                with span("render"):
                    out = render_maps(c2w)
                with span("drain"):  # the device finishing the request
                    if device.type == "cuda":
                        done = torch.cuda.Event()
                        done.record()
                        done.synchronize()
                with span("copy"):
                    maps = maps_to_host(out, device)
                return maps, time.perf_counter() - t0
            finally:
                lock.release()

    # The handler draws a request's id here, to send it back with the image.
    render.request_ids = request_ids

    # One render at start-up builds the kernel and loads the card's
    # libraries, so the first request pays no set-up.
    _, warm_s = render(scene.poses[0])
    print(f"warm-up render {warm_s:.2f} s")
    return render, step, (H, W)


def make_handler(render, step, hw):
    """The HTTP request handler class over a ``build()`` render function,
    whose ``request_ids`` number the answers (``X-Request-Id``)."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="application/json",
                  request_id=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            if request_id is not None:
                self.send_header("X-Request-Id", str(request_id))
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/health":
                self._send(200, json.dumps(
                    {"status": "ok", "step": step, "resolution": hw}).encode())
            elif url.path == "/render":
                q = parse_qs(url.query)
                try:
                    theta = float(q.get("theta", ["0"])[0])
                    phi = float(q.get("phi", ["-30"])[0])
                    radius = float(q.get("radius", ["4"])[0])
                except ValueError as e:
                    return self._send(400, json.dumps(
                        {"error": f"bad request: {e}"}).encode())
                self._render(pose_spherical(theta, phi, radius), "png")
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            if urlparse(self.path).path != "/render":
                return self._send(404, b'{"error": "not found"}')
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n))
                c2w = np.asarray(req["c2w"], np.float32)
                fmt = req.get("format", "png")
                if c2w.shape not in ((3, 4), (4, 4)) or fmt not in ("png", "npy"):
                    raise ValueError(f"c2w {c2w.shape}, format {fmt!r}")
            except (ValueError, KeyError, TypeError) as e:
                return self._send(400, json.dumps(
                    {"error": f"bad request: {e}"}).encode())
            self._render(c2w, fmt)

        def _render(self, c2w, fmt):
            rid = next(render.request_ids)
            try:
                maps, dt = render(c2w, request_id=rid)
            except Exception:  # keep serving; report the failure
                traceback.print_exc()
                return self._send(500, b'{"error": "render failed"}',
                                  request_id=rid)
            rgb = maps["rgb_map"]
            if fmt == "npy":
                buf = io.BytesIO()
                np.save(buf, rgb)
                self._send(200, buf.getvalue(), "application/octet-stream",
                           request_id=rid)
            else:
                img = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
                self._send(200, encode_png(img), "image/png", request_id=rid)
            print(f"request {rid} rendered in {dt:.2f}s")

        def log_message(self, *a):
            pass

    return Handler


def parse_server_args(argv=None) -> argparse.Namespace:
    """The server's own flags; everything after ``--`` goes to the training
    parser in ``build`` (``train_args``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--baked", action="store_true",
                    help="bake the field at start-up; serve from the "
                         "deferred-shading snapshot (render/baked.py)")
    ap.add_argument("--baked_res", type=int, default=256)
    ap.add_argument("--baked_geo_res", type=int, default=-1,
                    help="pass-2 geo table resolution (-1 = baked_res/2, "
                         "0 = baked_res)")
    ap.add_argument("--baked_dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "int8", "int8sig",
                             "int8geo"])
    ap.add_argument("--snapshot", default=None,
                    help="path to save/load the baked snapshot (loads it "
                         "if the file exists, else bakes and saves)")
    ap.add_argument("--guided", type=int, default=0,
                    help="with --baked: depth-guided two-level rendering "
                         "(coarse downsample factor, e.g. 4)")
    ap.add_argument("train_args", nargs=argparse.REMAINDER,
                    help="the training CLI flags identifying the run "
                         "(e.g. -- --flagship --dataset_type synthetic ...)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_server_args(argv)
    render, step, hw = build(args)
    srv = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(render, step, hw))
    print(f"serving on :{args.port} (step {step}, {hw[0]}x{hw[1]})")
    srv.serve_forever()


if __name__ == "__main__":
    main()
