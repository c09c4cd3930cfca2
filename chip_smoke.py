#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: build, check, serve.

    python3 chip_smoke.py

Four phases, each printing its lines; any failure raises and the run exits
non-zero. There is no CPU fallback: without a CUDA card it exits 1 before
printing any result.

  (a) device: name, torch / CUDA versions, nvidia-smi name and power limit;
  (b) build: compiles csrc/tent_contract.cu with nvcc for sm_90a;
  (c) kernel against its plain PyTorch version at the serving shapes
      (flagship side 4 / lpf 64 / F 4 over a bf16 [65536, 256] table with
      M = 16384 rays x 32 samples x 8 levels; side 5 / lpf 128 / F 2; a
      ragged M), max |diff| <= 1e-5, both timed with CUDA events;
  (d) serving: indoor_nerf_tpu_torch.serve's build() and handler on
      127.0.0.1 at 800x800 with the flagship preset answer /health and
      three renders; every render must launch the kernel. Then one
      100x100 image is rendered through the kernel and through the plain
      version: rgb max |diff| <= 1e-4.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from unittest import mock

import numpy as np

SERVE_FLAGS = ["--flagship", "--dataset_type", "synthetic", "--use_viewdirs",
               "--white_bkgd"]
KERNEL_TOL = 1e-5  # f32 accumulation both sides; summation order differs
RENDER_TOL = 1e-4


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(torch) -> str:
    name = torch.cuda.get_device_name(0)
    print(f"[a] device cuda:0 {name}; {torch.cuda.device_count()} visible; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(f"[a] nvidia-smi: {smi.stdout.strip().splitlines()[0]}")
    return name


def phase_build() -> None:
    from indoor_nerf_tpu_torch.cuda_build import ARCH_FLAGS, load_library

    t0 = time.perf_counter()
    built = load_library("tent_contract")
    print(f"[b] built indoor_nerf_tpu_torch/csrc/tent_contract.cu with nvcc "
          f"{' '.join(ARCH_FLAGS)} in {built.seconds:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s) -> {built.path.name}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[b] ptxas: {line.strip()}")


def phase_kernel(torch) -> dict:
    from indoor_nerf_tpu_torch.ops import tent_contract as tc

    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [  # (label, side, F, n_rows, M, table dtype)
        ("flagship", 4, 4, 65536, 16384 * 32 * 8, torch.bfloat16),
        ("block_size4", 5, 2, 32768, 1 << 20, torch.float32),
        ("ragged", 4, 4, 65536, 12345, torch.bfloat16),
    ]
    flagship = None
    for label, side, F, n_rows, M, dtype in cases:
        lpf = tc.lanes_per_feature(side)
        table = torch.randn((n_rows, F * lpf), generator=g, device=dev).to(dtype)
        flat_row = torch.randint(0, n_rows, (M,), generator=g, device=dev,
                                 dtype=torch.int32)
        p = torch.rand((M, 3), generator=g, device=dev) * (side - 1)
        p[:4096] = torch.randint(0, side, (4096, 3), generator=g,
                                 device=dev).float()  # tent kinks
        got = tc.tent_contract(table, flat_row, p, side, F)
        want = tc.tent_contract_plain(table, flat_row, p, side, F)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (got.shape == (M, F) and err <= KERNEL_TOL):
            raise AssertionError(f"{label}: kernel vs plain max |diff| {err} "
                                 f"> {KERNEL_TOL} (shape {tuple(got.shape)})")
        iters = 20 if M > 100000 else 200
        def run_k():
            tc.tent_contract(table, flat_row, p, side, F)

        def run_p():
            tc.tent_contract_plain(table, flat_row, p, side, F)

        # Alternate plain, kernel, kernel, plain within this one process.
        t = [cuda_ms(torch, f, iters) for f in (run_p, run_k, run_k, run_p)]
        ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        print(f"[c] {label}: side {side} lpf {lpf} F {F} table "
              f"{tuple(table.shape)} {str(dtype)[6:]} M {M}: max |diff| "
              f"{err:.3e} (tol {KERNEL_TOL}); kernel {ms:.4f} ms "
              f"({t[1]:.4f}, {t[2]:.4f}), plain {plain_ms:.4f} ms "
              f"({t[0]:.4f}, {t[3]:.4f})")
        if label == "flagship":
            flagship = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        del table, flat_row, p, got, want
    torch.cuda.empty_cache()
    return flagship


def _request(url, body=None):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        status, ctype, data = r.status, r.headers["Content-Type"], r.read()
    return status, ctype, data, time.perf_counter() - t0


def phase_serving(torch) -> int:
    from indoor_nerf_tpu_torch import serve
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.ops import tent_contract as tc
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.utils.png import decode_png

    args = argparse.Namespace(width=800, height=800,
                              train_args=["--"] + SERVE_FLAGS)
    render, step, hw = serve.build(args)
    captured = []

    def recorded(c2w):
        maps, dt = render(c2w)
        captured.append((maps, dt))
        return maps, dt

    scene = load_dataset(parse_args(SERVE_FLAGS))
    test_poses = scene.poses[scene.i_test]
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              serve.make_handler(recorded, step, hw))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    requests = [
        ("POST /render png (test pose 0)", "/render",
         {"c2w": test_poses[0][:3].tolist(), "format": "png"}),
        ("POST /render npy (test pose 1)", "/render",
         {"c2w": test_poses[1][:3].tolist(), "format": "npy"}),
        ("GET /render?theta=45&phi=-30&radius=4",
         "/render?theta=45&phi=-30&radius=4", None),
    ]
    torch.cuda.reset_peak_memory_stats()
    try:
        tc.reset_launch_count()  # the main path's run starts here
        status, _, data, dt = _request(base + "/health")
        health = json.loads(data)
        if status != 200 or health["status"] != "ok":
            raise AssertionError(f"/health answered {status} {health}")
        print(f"[d] GET /health: {status} {health} in {dt * 1e3:.1f} ms")
        counts = [tc.launch_count()]
        for label, path, body in requests:
            status, ctype, data, latency = _request(base + path, body)
            counts.append(tc.launch_count())
            if status != 200:
                raise AssertionError(f"{label}: HTTP {status}")
            if ctype == "image/png":
                img = decode_png(data)
            else:
                img = np.load(io.BytesIO(data))
            if img.shape != (800, 800, 3):
                raise AssertionError(f"{label}: image {img.shape}")
            maps, render_s = captured[-1]
            for k in ("rgb_map", "depth_map"):
                if not np.all(np.isfinite(maps[k])):
                    raise AssertionError(f"{label}: non-finite {k}")
            if counts[-1] <= counts[-2]:
                raise AssertionError(f"{label}: tent_contract not launched")
            print(f"[d] {label}: {status} {ctype}, {len(data)} bytes, "
                  f"tent_contract launches +{counts[-1] - counts[-2]}")
            print(f"[d] latency {label}: {latency * 1e3:.1f} ms round trip, "
                  f"render {render_s * 1e3:.1f} ms")
            print(f"[d] rays/s {label}: {800 * 800 / render_s:.0f}")
        launches = tc.launch_count()  # the main path's run ends here
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")
    peak = torch.cuda.max_memory_allocated()
    print(f"[d] main path: {launches} tent_contract launches over 3 renders; "
          f"peak device memory {peak / 2**30:.2f} GiB")
    return launches


def phase_render_check(torch) -> None:
    """One 100x100 render through the kernel and through the plain version."""
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.models.field import init_field_params, serving_params
    from indoor_nerf_tpu_torch.ops import blockhash
    from indoor_nerf_tpu_torch.ops.tent_contract import tent_contract_plain
    from indoor_nerf_tpu_torch.render.renderer import make_image_renderer
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    dev = torch.device("cuda:0")
    cli = parse_args(SERVE_FLAGS)
    scene = load_dataset(cli)
    cfg = build_train_config(cli, scene)
    g = torch.Generator(device=dev).manual_seed(1)
    params = init_field_params(g, cfg.render.field, dev)
    # An O(1) table so the rays are not transparent, and a random grid.
    params["table"] = torch.randn(params["table"].shape, generator=g, device=dev)
    params = serving_params(params, cfg.render.field)
    occ = {"density": 4.0 * torch.rand(cfg.render.occupancy.n_cells,
                                        generator=g, device=dev)}
    H = W = 100
    focal = scene.hwf[2] * (W / scene.hwf[1])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    renderer = make_image_renderer(cfg.render.test_mode(), H, W)
    c2w = scene.poses[scene.i_test[0]]
    kern = renderer(params, c2w, K, scene.near, scene.far, occ)
    with mock.patch.object(blockhash, "tent_contract", tent_contract_plain):
        plain = renderer(params, c2w, K, scene.near, scene.far, occ)
    torch.cuda.synchronize()
    for k in ("rgb_map", "depth_map"):
        if not bool(torch.isfinite(kern[k]).all()):
            raise AssertionError(f"100x100 render: non-finite {k}")
    err = float((kern["rgb_map"] - plain["rgb_map"]).abs().max())
    acc = kern["acc_map"]
    print(f"[d] 100x100 render, kernel vs plain: rgb max |diff| {err:.3e} "
          f"(tol {RENDER_TOL}); acc in [{float(acc.min()):.3f}, "
          f"{float(acc.max()):.3f}]")
    if err > RENDER_TOL:
        raise AssertionError(f"render rgb kernel vs plain {err} > {RENDER_TOL}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    import indoor_nerf_tpu_torch  # noqa: F401  (sets the TF32 policy)

    torch.cuda.set_device(0)
    name = phase_device(torch)
    phase_build()
    flagship = phase_kernel(torch)
    launches = phase_serving(torch)
    phase_render_check(torch)
    print(json.dumps({"kernels": [{
        "name": "tent_contract",
        "route": "cuda",
        "source": "indoor_nerf_tpu_torch/csrc/tent_contract.cu",
        "replaces": "indoor_nerf_tpu/ops/pallas/tent_contract.py:167",
        "launches": launches,
        **flagship,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
