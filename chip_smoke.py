#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: build, check, serve, train.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and the run exits
non-zero. There is no CPU fallback: without a CUDA card it exits 1 before
printing any result.

  (a) device: name, torch / CUDA versions, nvidia-smi name and power limit;
  (b) build: compiles csrc/tent_contract.cu, csrc/table_scatter.cu and
      csrc/group_scatter.cu with nvcc for sm_90a, one nvcc per source,
      started together;
  (c) tent_contract against its plain PyTorch version at the serving shapes
      (flagship side 4 / lpf 64 / F 4 over a bf16 [65536, 256] table with
      M = 16384 rays x 32 samples x 8 levels; side 5 / lpf 128 / F 2; a
      ragged M), max |diff| <= 1e-5, both timed with CUDA events;
  (d) serving: indoor_nerf_tpu_torch.serve's build() and handler on
      127.0.0.1 at 800x800 with the flagship preset answer /health and
      three renders; every render must launch the kernel. Then one
      100x100 image is rendered through the kernel and through the plain
      version: rgb max |diff| <= 1e-4;
  (e) table_scatter against its plain version at the flagship training
      shape (M = 4096 rays x 32 samples x 8 levels = 1,048,576 rows, F 4,
      lpf 64, side 4, bf16 rounding, a [65536, 256] f32 table): random
      rows with integer and side - 1 positions, and every row on one table
      row; within 1e-4 relative and 1e-6 of the largest entry; both timed;
  (f) training: trainer.train on the flagship CLI for 200 steps at full
      width; both kernels must launch, the loss stay finite and the mean
      loss of the last 10 steps fall below that of the first 10;
  (g) one step from the trained params with both kernels and with both
      replaced by their plain versions, on the same draws: loss, grid and
      RAdam moments within the stated tolerances;
  (h) the training benchmark (indoor_nerf_tpu_torch.bench) JSON line;
  (i) group_scatter against its plain version at the flagship grouped
      shape (4096 rays x 32 samples x 8 levels, G 4,4,2,2,1,1,1,1: 720,896
      groups, F 4, lpf 64, side 4, bf16 rounding, a [65536, 256] f32
      table): random anchor rows with integer and side - 1 positions, and
      every group on one row; tolerances as (e); both timed;
  (j) grouped training: trainer.train on the flagship CLI with
      --ray_groups 4,4,2,2,1,1,1,1 for 200 steps; tent_contract and
      group_scatter must launch, the loss fall as in (f);
  (k) one grouped step from those params through the kernels and through
      the plain versions, held as (g);
  (l) strided training: --ray_strides 4,4,2,2,1,1,1,1 for 100 steps;
      tent_contract and table_scatter must launch, the loss fall;
  (m) the bench step with and without ray_groups 4,4,2,2,1,1,1,1 in
      eight alternating windows of 30 steps, in this one process.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
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
GROUPS = (4, 4, 2, 2, 1, 1, 1, 1)  # the 8-level --ray_groups of the help text
GROUP_FLAGS = SERVE_FLAGS + ["--ray_groups", ",".join(map(str, GROUPS))]
STRIDE_FLAGS = SERVE_FLAGS + ["--ray_strides", ",".join(map(str, GROUPS))]
KERNEL_TOL = 1e-5  # f32 accumulation both sides; summation order differs
RENDER_TOL = 1e-4
# table_scatter: f32 sums of the same rounded entries, in atomic orders
# that change from run to run (the plain version's index_add_ too).
SCATTER_RTOL = 1e-4
SCATTER_ATOL = 1e-6  # times the largest |entry|
TRAIN_STEPS = 200
STRIDED_STEPS = 100
TIMED_STEPS = 30  # per window of (m)


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
    from indoor_nerf_tpu_torch.cuda_build import ARCH_FLAGS, build_all

    t0 = time.perf_counter()
    built = build_all(["tent_contract", "table_scatter", "group_scatter"])
    print(f"[b] built {len(built)} kernels in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, lib in built.items():
        print(f"[b] indoor_nerf_tpu_torch/csrc/{name}.cu with nvcc "
              f"{' '.join(ARCH_FLAGS)}: {lib.seconds:.2f} s -> {lib.path.name}")
        for line in lib.log.splitlines():
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
        tc.reset_launch_count()  # the serving path's run starts here
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
        launches = tc.launch_count()  # the serving path's run ends here
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


def hold_scatter(torch, tag, what, kernel, plain, args, shape) -> dict:
    """A scatter kernel's result against its plain version's on ``args``
    (within SCATTER_RTOL and SCATTER_ATOL of the largest entry), then both
    timed alternately; returns the numbers of the kernels line."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    bound = SCATTER_ATOL * scale + SCATTER_RTOL * want.abs()
    if not (got.shape == shape and scale > 0
            and bool(((got - want).abs() <= bound).all())):
        raise AssertionError(
            f"{what}: {kernel.__name__} vs plain max |diff| {err} beyond "
            f"rtol {SCATTER_RTOL}, atol {SCATTER_ATOL} x {scale}")
    del got, want, bound
    t = [cuda_ms(torch, lambda f=f: f(*args), 10)
         for f in (plain, kernel, kernel, plain)]
    ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    print(f"[{tag}] {what}: max |diff| {err:.3e} (largest entry {scale:.3e}); "
          f"kernel {ms:.4f} ms ({t[1]:.4f}, {t[2]:.4f}), plain "
          f"{plain_ms:.4f} ms ({t[0]:.4f}, {t[3]:.4f})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_scatter(torch) -> dict:
    """(e) table_scatter against its plain version at the training shape."""
    from indoor_nerf_tpu_torch.ops import table_scatter as ts

    dev = torch.device("cuda:0")
    g0 = torch.Generator(device=dev).manual_seed(2)
    side, F, lpf, L, R = 4, 4, 64, 8, 8192
    M = 4096 * 32 * L
    flagship = None
    for label, one_row in (("flagship", False), ("one_row", True)):
        g = torch.randn((M, F), generator=g0, device=dev)
        if one_row:
            g = g.abs()  # sums of ~10^5 terms that do not cancel
        p = torch.rand((M, 3), generator=g0, device=dev) * (side - 1)
        p[:4096] = torch.randint(0, side, (4096, 3), generator=g0,
                                 device=dev).float()  # tent kinks
        p[4096:8192] = side - 1
        local = (torch.zeros(M, dtype=torch.int64, device=dev) if one_row else
                 torch.randint(0, R, (M,), generator=g0, device=dev))
        level = torch.arange(M, device=dev) % L  # level-minor, as the encode
        flat_row = (local + level * R).to(torch.int32)
        args = (g, p, flat_row, L * R, side, lpf, torch.bfloat16)
        stats = hold_scatter(
            torch, "e", f"{label}: M {M} F {F} lpf {lpf} side {side} bf16 "
            f"rounding, table {L * R}x{F * lpf} f32", ts.table_scatter,
            ts.table_scatter_plain, args, (L * R, F * lpf))
        flagship = flagship or stats
        del g, p, flat_row, args
    torch.cuda.empty_cache()
    return flagship


def phase_training(torch, tag, flags, steps, expect):
    """(f), (j), (l): ``steps`` flagship steps through trainer.train, the
    CLI's entry point; every kernel in ``expect`` must launch."""
    from indoor_nerf_tpu_torch.ops import group_scatter as gs
    from indoor_nerf_tpu_torch.ops import table_scatter as ts
    from indoor_nerf_tpu_torch.ops import tent_contract as tc
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.trainer import train

    modules = {"tent_contract": tc, "table_scatter": ts, "group_scatter": gs}
    args = parse_args(flags + ["--n_iters", str(steps), "--i_print", "50"])
    torch.cuda.reset_peak_memory_stats()
    for m in modules.values():  # this path's run starts here
        m.reset_launch_count()
    out = train(args)
    launches = {k: m.launch_count() for k, m in modules.items()}  # ... and ends here
    losses = np.asarray(out["losses"])
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    steps_s = steps / out["seconds"]
    print(f"[{tag}] {' '.join(flags[len(SERVE_FLAGS):]) or 'flat encode'}: "
          f"{steps} steps of {args.N_rand} rays: {steps_s:.2f} "
          f"steps/s, {steps_s * args.N_rand:.0f} rays/s; loss mean of the "
          f"first 10 steps {first:.6f}, last 10 {last:.6f}; PSNR "
          f"{out['psnrs'][0]:.2f} -> {out['psnrs'][-1]:.2f} dB; launches "
          f"{launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not np.all(np.isfinite(losses)):
        raise AssertionError("training loss went non-finite")
    if not last < first:
        raise AssertionError(f"loss did not fall: {first} -> {last}")
    for name in expect:
        if launches[name] <= 0:
            raise AssertionError(f"training launched no {name} kernel")
    return out, launches


def phase_step_check(torch, tag, flags, trained) -> None:
    """(g), (k) One step with the kernels and with their plain versions."""
    from indoor_nerf_tpu_torch.data.pipeline import BatchedRaySampler
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.ops import blockhash
    from indoor_nerf_tpu_torch.ops.group_scatter import group_scatter_plain
    from indoor_nerf_tpu_torch.ops.table_scatter import table_scatter_plain
    from indoor_nerf_tpu_torch.ops.tent_contract import tent_contract_plain
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.step import draw_step, make_train_state, train_step
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    dev = torch.device("cuda:0")
    cli = parse_args(flags)
    scene = load_dataset(cli)
    cfg = build_train_config(cli, scene)
    H, W, _ = scene.hwf
    b = BatchedRaySampler(scene.images, scene.poses, scene.i_train, H, W,
                          scene.K, cli.N_rand, seed=5).next()
    batch = {k: torch.from_numpy(b[k]).to(dev)
             for k in ("rays_o", "rays_d", "target")}
    params = {k: v.detach() for k, v in trained["params"].items()
              if not isinstance(v, torch.nn.Module)}
    params["coarse"] = copy.deepcopy(trained["params"]["coarse"])
    draws = draw_step(torch.Generator(device=dev).manual_seed(3), cfg, 0,
                      cli.N_rand)

    def one_step():
        # Zero moments: after this first step mu = 0.1 g and nu = 0.01 g^2.
        state = make_train_state(copy.deepcopy(params), trained["occ"].copy())
        return train_step(state, batch, cfg, draws=draws)

    kern, km = one_step()
    with mock.patch.object(blockhash, "tent_contract", tent_contract_plain), \
            mock.patch.object(blockhash, "table_scatter", table_scatter_plain), \
            mock.patch.object(blockhash, "group_scatter", group_scatter_plain):
        plain, pm = one_step()
    torch.cuda.synchronize()
    loss_err = abs(float(km["loss"]) - float(pm["loss"])) / float(pm["loss"])
    occ_err = float((kern["occ"]["density"] - plain["occ"]["density"]).abs().max())
    # A cotangent an f32 ulp apart can round to the neighbouring bf16
    # value: one bf16 ulp (2^-8) of one term of the table's gradient entry.
    checks = [("loss (relative)", loss_err, 1e-5),
              ("occ density", occ_err, 1e-4 * float(plain["occ"]["density"].abs().max()))]
    for key, tol in (("mu", 2.0 ** -8), ("nu", 2.0 ** -7)):
        for name, want in plain["opt"][key].items():
            got = kern["opt"][key][name]
            rel = 1e-4 if name != "table" else tol
            checks.append((f"{key} {name}", float((got - want).abs().max()),
                           rel * float(want.abs().max())))
        gt, wt = kern["opt"][key]["table"], plain["opt"][key]["table"]
        checks.append((f"{key} table (relative norm)",
                       float(torch.linalg.norm(gt - wt) / torch.linalg.norm(wt)),
                       1e-3))
    for what, err, tol in checks:
        if not err <= tol:
            raise AssertionError(f"kernels vs plain step: {what} {err} > {tol}")
    print(f"[{tag}] one step, kernels vs plain versions: loss "
          f"{float(km['loss']):.6f} vs {float(pm['loss']):.6f}; "
          + "; ".join(f"{w} {e:.3e} (tol {t:.3e})" for w, e, t in checks))


def phase_group_scatter(torch) -> dict:
    """(i) group_scatter against its plain version at the grouped shape."""
    from indoor_nerf_tpu_torch.ops import group_scatter as gs

    dev = torch.device("cuda:0")
    g0 = torch.Generator(device=dev).manual_seed(4)
    side, F, lpf, L, R = 4, 4, 64, 8, 8192
    Rn, S = 4096, 32
    n_groups = Rn * sum(S // G for G in GROUPS)
    flagship = None
    for label, one_row in (("flagship", False), ("one_row", True)):
        g = torch.randn((Rn, S, L * F), generator=g0, device=dev)
        if one_row:
            g = g.abs()  # sums of ~10^5 terms that do not cancel
        p = torch.rand((Rn, S, L, 3), generator=g0, device=dev) * (side - 1)
        flat = p.view(-1, 3)
        flat[:4096] = torch.randint(0, side, (4096, 3), generator=g0,
                                    device=dev).float()  # tent kinks
        flat[4096:8192] = side - 1
        row = torch.empty((Rn, S, L), dtype=torch.int32, device=dev)
        for l, G in enumerate(GROUPS):  # one anchor row per group
            local = (torch.zeros((Rn, S // G), dtype=torch.int64, device=dev)
                     if one_row else torch.randint(0, R, (Rn, S // G),
                                                   generator=g0, device=dev))
            row[:, :, l] = (local.repeat_interleave(G, dim=1) + l * R).int()
        args = (g, row, p, GROUPS, L * R, side, lpf, torch.bfloat16)
        stats = hold_scatter(
            torch, "i", f"{label}: {Rn} rays x {S} samples x {L} levels, G "
            f"{GROUPS} ({n_groups} groups), F {F} lpf {lpf} side {side} bf16 "
            f"rounding, table {L * R}x{F * lpf} f32", gs.group_scatter,
            gs.group_scatter_plain, args, (L * R, F * lpf))
        flagship = flagship or stats
        del g, p, flat, row, args
    torch.cuda.empty_cache()
    return flagship


def phase_group_timing(torch) -> None:
    """(m) The bench step with and without grouping, in alternating windows."""
    from indoor_nerf_tpu_torch import bench
    from indoor_nerf_tpu_torch.train.step import init_train_state, train_step

    dev = torch.device("cuda:0")
    flat = bench.bench_config()
    fc = flat.render.field
    grouped = dataclasses.replace(flat, render=dataclasses.replace(
        flat.render, field=dataclasses.replace(fc, block_grid=dataclasses.replace(
            fc.block_grid, ray_groups=GROUPS))))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in bench.bench_batch().items()}
    runs = {}
    for name, cfg in (("ungrouped", flat), ("grouped", grouped)):
        state = init_train_state(torch.Generator(device=dev).manual_seed(0),
                                 cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        for _ in range(TIMED_STEPS):  # warm-up, as the bench
            state, _ = train_step(state, batch, cfg, gen)
        runs[name] = (cfg, state, gen)
    torch.cuda.synchronize(dev)
    ms = {"ungrouped": [], "grouped": []}
    for name in ("ungrouped", "grouped", "grouped", "ungrouped") * 2:
        cfg, state, gen = runs[name]
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            state, metrics = train_step(state, batch, cfg, gen)
        torch.cuda.synchronize(dev)
        ms[name].append((time.perf_counter() - t0) / TIMED_STEPS * 1e3)
        if not np.isfinite(float(metrics["loss"])):
            raise AssertionError(f"{name} bench step: non-finite loss")
    print(f"[m] bench step, {TIMED_STEPS} steps per window, alternating: "
          + "; ".join(f"{k} {', '.join(f'{v:.3f}' for v in vs)} ms/step "
                      f"({bench.N_RAND / (sum(vs) / len(vs)) * 1e3:.0f} rays/s)"
                      for k, vs in ms.items()))


def phase_bench(torch) -> None:
    """(h) The training benchmark's JSON line."""
    from indoor_nerf_tpu_torch import bench

    print(f"[h] {json.dumps(bench.run())}")


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
    tent = phase_kernel(torch)
    serve_launches = phase_serving(torch)
    phase_render_check(torch)
    scatter = phase_scatter(torch)
    trained, flat_launches = phase_training(
        torch, "f", SERVE_FLAGS, TRAIN_STEPS, ("tent_contract", "table_scatter"))
    phase_step_check(torch, "g", SERVE_FLAGS, trained["state"])
    phase_bench(torch)
    grouped = phase_group_scatter(torch)
    trained, group_launches = phase_training(
        torch, "j", GROUP_FLAGS, TRAIN_STEPS, ("tent_contract", "group_scatter"))
    phase_step_check(torch, "k", GROUP_FLAGS, trained["state"])
    _, stride_launches = phase_training(
        torch, "l", STRIDE_FLAGS, STRIDED_STEPS, ("tent_contract", "table_scatter"))
    phase_group_timing(torch)
    # "launches" is the count of the path of this slice that runs the
    # kernel (grouped training for tent_contract and group_scatter, strided
    # training for table_scatter); "launches_by_path" gives every path that
    # runs it its own count, each read from its own reset-then-read window.
    paths = {"training": flat_launches, "training_grouped": group_launches,
             "training_strided": stride_launches}

    def by_path(name):
        return {p: n[name] for p, n in paths.items()}

    print(json.dumps({"kernels": [
        {"name": "tent_contract", "route": "cuda",
         "source": "indoor_nerf_tpu_torch/csrc/tent_contract.cu",
         "replaces": "indoor_nerf_tpu/ops/pallas/tent_contract.py:167",
         "launches": group_launches["tent_contract"],
         "launches_by_path": {"serving": serve_launches,
                              **by_path("tent_contract")},
         **tent},
        {"name": "table_scatter", "route": "cuda",
         "source": "indoor_nerf_tpu_torch/csrc/table_scatter.cu",
         "replaces": "indoor_nerf_tpu/ops/pallas/table_scatter.py:399",
         "launches": stride_launches["table_scatter"],
         "launches_by_path": by_path("table_scatter"),
         **scatter},
        {"name": "group_scatter", "route": "cuda",
         "source": "indoor_nerf_tpu_torch/csrc/group_scatter.cu",
         "replaces": "indoor_nerf_tpu/ops/pallas/table_scatter.py:494",
         "launches": group_launches["group_scatter"],
         "launches_by_path": by_path("group_scatter"),
         **grouped},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
