"""Profile one training step, or one render request, of a CLI configuration
on one CUDA card.

    python -m indoor_nerf_tpu_torch.profile_step -- <training flags>
    python -m indoor_nerf_tpu_torch.profile_step --render 800 -- <training flags>
    python -m indoor_nerf_tpu_torch.profile_step --render 800 --baked \
        [--guided 4] [--snapshot FILE] -- <training flags>

Without ``--render``: builds the config and a batch as the trainer would
(``train/trainer.py::one_batch``) on the flags' ``--device``, takes 20
warm-up steps on that batch, then records one step that is not a
grid-refresh step with ``torch.profiler``. With ``--render N``: sets up the
server's render function (``serve.build``, an N x N view, one warm-up
render inside), renders a second pose unrecorded, then records the render
of a third; ``--baked`` (with ``--guided``, ``--snapshot``, ``--baked_res``
as the server takes them) records a request to the baked renderer. The
training flags name the run whose newest checkpoint is served.

Prints the wall time of the recorded work, the device's busy time (the sum
of its kernels and copies), the ``record_function`` spans as the device saw
them (intervals from a span's first kernel to its last, which hold the idle
gaps between them: an upper bound of the span's device time), the 12
device kernels that take most of the busy time, and the package's own
kernels (``csrc/``) whatever their rank. The profiler inflates the wall
time, not the device times. Exits 1 unless the device is a visible
CUDA card: the numbers are the card's.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

WARMUP_STEPS = 20
TOP_KERNELS = 12
SPANS = ("sample", "encode", "mlp", "composite", "tv", "priors", "backward",
         "encode_bwd", "optimizer", "occ_update", "baked_sample",
         "baked_pass1", "baked_composite", "baked_pass2", "baked_color")
# The kernels of csrc/, by a part of their names on the device.
OWN_KERNELS = ("tent_contract_kernel", "pack_rows_kernel", "table_scatter_kernel",
               "unpack_rows_kernel", "group_scatter_kernel", "tile_interp",
               "lane_select")


def _training_work(torch, cli):
    """``(label, work)``: ``work()`` takes the step to record."""
    from indoor_nerf_tpu_torch.train.step import init_train_state, train_step
    from indoor_nerf_tpu_torch.train.trainer import one_batch

    dev = torch.device(cli.device)
    cfg, batch = one_batch(cli, dev)
    state = init_train_state(torch.Generator(device=dev).manual_seed(cli.seed),
                             cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(cli.seed + 1)
    interval = cfg.render.occupancy.update_interval if cfg.render.occupancy else 0
    steps = WARMUP_STEPS
    while interval and steps % interval == 0:
        steps += 1  # the recorded step is not a refresh step
    for _ in range(steps):
        state, _ = train_step(state, batch, cfg, gen)
    return (f"step {state['step']} recorded",
            lambda: train_step(state, batch, cfg, gen))


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


def measure(torch, work, dev) -> dict:
    """Record ``work()`` (closed by a device synchronize) with
    ``torch.profiler``: ``wall_ms`` (profiled), ``busy_ms`` (the sum of the
    device's kernels and copies), ``n_ops``, ``spans`` {name: (interval ms,
    count)} and ``kernels`` (the device events, spans left out)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # A span shows up on the device's side too, as an interval that covers
    # its kernels and the gaps between them; only kernels and copies count
    # as busy time.
    on_device = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    kernels = [e for e in on_device if e.key not in SPANS]
    return {"wall_ms": wall_ms,
            "busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "n_ops": sum(e.count for e in kernels),
            "spans": {e.key: (e.device_time_total / 1e3, e.count)
                      for e in on_device if e.key in SPANS},
            "kernels": kernels}


def summary(m: dict) -> str:
    """The first two lines of the report of a ``measure`` result."""
    return (f"wall {m['wall_ms']:.3f} ms (profiled), device busy "
            f"{m['busy_ms']:.3f} ms in {m['n_ops']} device operations, idle "
            f"share {max(0.0, 1 - m['busy_ms'] / m['wall_ms']):.3f} (of the "
            "profiled wall)\nspans on the device (intervals, gaps included): "
            + ", ".join(f"{k} {m['spans'][k][0]:.3f} ms x{m['spans'][k][1]}"
                        for k in SPANS if k in m["spans"]))


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
