"""Render server: novel views of the field over HTTP (port of scripts/serve.py).

  python -m indoor_nerf_tpu_torch.serve [--port 8000] [--width 800 --height 800] \\
      -- --flagship --dataset_type synthetic --use_viewdirs --white_bkgd

Renders on the CUDA card (the block-hash encode then runs the hand-written
``tent_contract`` kernel) unless the training flags hold ``--device cpu``;
with no card visible and no such flag it raises.
There is no checkpoint format yet, so it serves the seeded initial state
(``--seed``) and says so. Baked serving comes with ROADMAP.md Queue 1 item
7: its flags (``--baked``, ``--baked_res``, ``--baked_geo_res``,
``--baked_dtype``, ``--snapshot``, ``--guided``) are parsed and raise
``NotImplementedError`` naming that item.

API:
  GET  /health              -> {"status": "ok", "step": N, "resolution": [H, W]}
  POST /render              body: {"c2w": [[...3x4...]], "format": "png"}
                            -> image/png (or .npy of the rgb map with "npy")
  GET  /render?theta=..&phi=..&radius=..   spherical orbit shortcut
"""

from __future__ import annotations

import argparse
import io
import json
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
from indoor_nerf_tpu_torch.models.field import init_field_params, serving_params
from indoor_nerf_tpu_torch.ops.occupancy import init_occupancy
from indoor_nerf_tpu_torch.render.renderer import default_tile_rays, make_image_renderer
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.train.trainer import build_train_config
from indoor_nerf_tpu_torch.utils.png import encode_png

# The baked-serving flags of the JAX server and their defaults there.
_BAKED_FLAGS = (("baked", False), ("baked_res", 256), ("baked_geo_res", -1),
                ("baked_dtype", "bfloat16"), ("snapshot", None), ("guided", 0))


def build(args):
    """Set up the field and renderer. Returns ``(render, step, (H, W))``;
    ``render(c2w) -> (maps, seconds)`` with numpy rgb/depth/acc/disp maps."""
    for flag, default in _BAKED_FLAGS:
        if getattr(args, flag, default) != default:
            raise NotImplementedError(
                f"--{flag}: baked serving comes with ROADMAP.md Queue 1 item 7")
    train_args = list(args.train_args)
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    cli = parse_args(train_args)
    scene = load_dataset(cli)
    cfg = build_train_config(cli, scene)
    device = resolve_device(cli.device)
    gen = torch.Generator(device=device).manual_seed(cli.seed)
    field_cfg = cfg.render.field
    # Serving holds the params fixed, so the bf16 gather copy of the table
    # is made once here (valid while these params are served unchanged).
    params = serving_params(init_field_params(gen, field_cfg, device), field_cfg)
    occ = (init_occupancy(cfg.render.occupancy, device)
           if cfg.render.occupancy is not None else None)
    step = 0
    print("⚠️  serving an UNTRAINED model (the port has no checkpoint "
          f"format yet; seeded initial state, seed {cli.seed})")

    H = int(args.height or scene.hwf[0])
    W = int(args.width or scene.hwf[1])
    focal = scene.hwf[2] * (W / scene.hwf[1])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    tile = default_tile_rays(device, cfg.render)
    print(f"rendering {H}x{W} on {device} in tiles of {tile} rays")
    renderer = make_image_renderer(cfg.render.test_mode(), H, W, tile)
    lock = threading.Lock()  # one render at a time on the card

    def render(c2w):
        with lock:
            t0 = time.perf_counter()
            out = renderer(params, c2w, K, scene.near, scene.far, occ)
            maps = {k: v.cpu().numpy() for k, v in out.items()}  # synchronizes
            return maps, time.perf_counter() - t0

    # One render at start-up builds the kernel and loads the card's
    # libraries, so the first request pays no set-up.
    _, warm_s = render(scene.poses[0])
    print(f"warm-up render {warm_s:.2f} s")
    return render, step, (H, W)


def make_handler(render, step, hw):
    """The HTTP request handler class over a ``build()`` render function."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
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
            try:
                maps, dt = render(c2w)
            except Exception:  # keep serving; report the failure
                traceback.print_exc()
                return self._send(500, b'{"error": "render failed"}')
            rgb = maps["rgb_map"]
            if fmt == "npy":
                buf = io.BytesIO()
                np.save(buf, rgb)
                self._send(200, buf.getvalue(), "application/octet-stream")
            else:
                img = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
                self._send(200, encode_png(img), "image/png")
            print(f"rendered in {dt:.2f}s")

        def log_message(self, *a):
            pass

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    for flag, default in _BAKED_FLAGS:  # parsed, then refused by build()
        if default is False:
            ap.add_argument(f"--{flag}", action="store_true")
        else:
            ap.add_argument(f"--{flag}", default=default,
                            type=int if isinstance(default, int) else str)
    ap.add_argument("train_args", nargs=argparse.REMAINDER,
                    help="the training CLI flags identifying the run "
                         "(e.g. -- --flagship --dataset_type synthetic ...)")
    args = ap.parse_args(argv)
    render, step, hw = build(args)
    srv = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(render, step, hw))
    print(f"serving on :{args.port} (step {step}, {hw[0]}x{hw[1]})")
    srv.serve_forever()


if __name__ == "__main__":
    main()
