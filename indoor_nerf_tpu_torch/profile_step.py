"""Profile one training step, or one render request, of a CLI configuration
on one CUDA card.

    python -m indoor_nerf_tpu_torch.profile_step -- <training flags>
    python -m indoor_nerf_tpu_torch.profile_step --render 800 -- <training flags>
    python -m indoor_nerf_tpu_torch.profile_step --render 800 --baked \
        [--guided 4] [--snapshot FILE] -- <training flags>

Without ``--render``: builds the config and the ray sampler as the trainer
would on the flags' ``--device``, takes 20 warm-up steps as the trainer
takes them (``device_batch``, ``train_step``, the loss read through
``wait_read``), then records the next two steps, neither a grid-refresh
step. With ``--render N``: sets up the server's render function
(``serve.build``, an N x N view, one warm-up render inside), renders a
second pose unrecorded, then records the render of a third; ``--baked``
(with ``--guided``, ``--snapshot``, ``--baked_res`` as the server takes
them) records a request to the baked renderer. The training flags name
the run whose newest checkpoint is served.

The work is run twice: once untraced with the span recorder on
(``utils/spans.py``), for each span's host time, then under the profiler.
Prints the wall time of the profiled work, the device's busy time (the
union of its kernels', copies' and sets' intervals), the spans as the
device saw them (intervals from a span's first kernel to its last, which
hold the idle gaps between them: an upper bound of the span's device
time), the recorder's host ms per span (total and self) of the untraced
run, the 12 device kernels that take most of the busy time, and the
package's own kernels (``csrc/``) whatever their rank. The profiler
inflates the wall time, not the device times. Exits 1 unless the device is
a visible CUDA card: the numbers are the card's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from indoor_nerf_tpu_torch.utils import spans

WARMUP_STEPS = 20
TOP_KERNELS = 12
# The device events of a Chrome trace that count as busy time.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The kernels of csrc/, by a part of their names on the device.
OWN_KERNELS = ("tent_contract_kernel", "pack_rows_kernel", "table_scatter_kernel",
               "unpack_rows_kernel", "group_scatter_kernel", "tile_interp",
               "lane_select")


def _training_work(torch, cli):
    """``(label, work)``: ``work()`` takes the next step as the trainer
    takes it: its batch from the sampler, the step, the loss's read."""
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.train.step import init_train_state, train_step
    from indoor_nerf_tpu_torch.train.trainer import (
        build_train_config,
        device_batch,
        enable_normals,
        make_sampler,
        wait_read,
    )

    dev = torch.device(cli.device)
    enable_normals(cli)
    scene = load_dataset(cli)
    cfg = build_train_config(cli, scene)
    sample, _ = make_sampler(cli, scene, cfg, cli.seed)
    state = init_train_state(torch.Generator(device=dev).manual_seed(cli.seed),
                             cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(cli.seed + 1)

    def step():
        batch = device_batch(sample, state["step"] + 1, dev)
        _, metrics = train_step(state, batch, cfg, gen)
        metrics["loss"].to("cpu", non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        wait_read(done)

    interval = cfg.render.occupancy.update_interval if cfg.render.occupancy else 0
    steps = WARMUP_STEPS
    while interval and (steps % interval == 0 or (steps + 1) % interval == 0):
        steps += 1  # neither recorded step is a refresh step
    for _ in range(steps):
        step()
    return f"steps {state['step']} (host) and {state['step'] + 1} recorded", step


def _render_work(cli, train_args, opts):
    """``(label, work)``: ``work()`` answers the render to record."""
    from indoor_nerf_tpu_torch import serve
    from indoor_nerf_tpu_torch.data.load import load_dataset

    render, _, hw = serve.build(argparse.Namespace(
        width=opts.render, height=opts.render, baked=opts.baked,
        baked_res=opts.baked_res, guided=opts.guided, snapshot=opts.snapshot,
        train_args=["--"] + train_args))
    scene = load_dataset(cli)
    poses = scene.poses[scene.i_test]
    render(poses[0])
    return (f"one {hw[0]}x{hw[1]} render recorded",
            lambda: render(poses[1 % len(poses)]))


def _busy_ms(prof) -> float:
    """The union of the device operations' intervals in ``prof``'s trace."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return spans.union_length(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS) / 1e3


def measure(torch, work, dev) -> dict:
    """Run ``work()`` twice, each closed by a device synchronize: untraced
    with the span recorder on, giving ``host`` {name: (total ms, self ms)}
    over the units it closed, then under ``torch.profiler``, giving
    ``wall_ms`` (profiled), ``busy_ms`` (the union of the intervals of the
    device's kernels, copies and sets), ``n_ops``, ``spans`` {name:
    (interval ms, count)} and ``kernels`` (the device events, spans left
    out)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    spans.reset()
    spans.enable()
    try:
        work()
        torch.cuda.synchronize(dev)
    finally:
        spans.disable()
    host = {k: (v["total_ns"] / 1e6, v["self_ns"] / 1e6)
            for k, v in spans.snapshot()["totals"].items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # A span shows up on the device's side too, as an interval that covers
    # its kernels and the gaps between them; only kernels and copies count
    # as busy time.
    on_device = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    kernels = [e for e in on_device if e.key not in spans.NAMES]
    return {"wall_ms": wall_ms,
            "busy_ms": _busy_ms(prof),
            "n_ops": sum(e.count for e in kernels),
            "spans": {e.key: (e.device_time_total / 1e3, e.count)
                      for e in on_device if e.key in spans.NAMES},
            "host": host,
            "kernels": kernels}


def summary(m: dict) -> str:
    """The first three lines of the report of a ``measure`` result."""
    return (f"wall {m['wall_ms']:.3f} ms (profiled), device busy "
            f"{m['busy_ms']:.3f} ms in {m['n_ops']} device operations, idle "
            f"share {max(0.0, 1 - m['busy_ms'] / m['wall_ms']):.3f} (of the "
            "profiled wall)\nspans on the device (intervals, gaps included): "
            + ", ".join(f"{k} {m['spans'][k][0]:.3f} ms x{m['spans'][k][1]}"
                        for k in spans.NAMES if k in m["spans"])
            + "\nspans on the host (untraced, recorder on; total/self ms): "
            + ", ".join(f"{k} {m['host'][k][0]:.3f}/{m['host'][k][1]:.3f}"
                        for k in spans.NAMES if k in m["host"]))


def main(argv=None) -> int:
    import torch

    from indoor_nerf_tpu_torch.train.config import parse_args

    argv = list(sys.argv[1:] if argv is None else argv)
    own = argv[:argv.index("--")] if "--" in argv else []
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--render", type=int, default=None, metavar="N",
                    help="profile one N x N render request, not a step")
    ap.add_argument("--baked", action="store_true",
                    help="with --render: a request to the baked renderer")
    ap.add_argument("--baked_res", type=int, default=256)
    ap.add_argument("--guided", type=int, default=0)
    ap.add_argument("--snapshot", default=None)
    opts = ap.parse_args(own)
    train_args = [a for a in argv[len(own):] if a != "--"]
    cli = parse_args(train_args)
    if torch.device(cli.device).type != "cuda" or not torch.cuda.is_available():
        print(f"profile_step: --device {cli.device} is no visible CUDA device "
              f"(torch.cuda.is_available() is {torch.cuda.is_available()}); "
              "the numbers are the card's", file=sys.stderr)
        return 1
    dev = torch.device(cli.device)
    label, work = (_training_work(torch, cli) if opts.render is None
                   else _render_work(cli, train_args, opts))
    torch.cuda.synchronize(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(f"profile_step: {smi.stdout.strip().splitlines()[0]}; "
          f"{' '.join(train_args)}; {label}")
    m = measure(torch, work, dev)
    print(summary(m))
    kernels = m["kernels"]
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP_KERNELS]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
              f"{e.key[:110]}")
    print("the package's own kernels:")
    for e in kernels:
        if any(name in e.key for name in OWN_KERNELS):
            print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
                  f"{e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
