"""Profile one training step of a CLI configuration on one CUDA card.

    python -m indoor_nerf_tpu_torch.profile_step -- <training flags>

Builds the config and a batch as the trainer would
(``train/trainer.py::one_batch``) on the flags' ``--device``, takes 20
warm-up steps on that batch, then records one step that is not a
grid-refresh step with ``torch.profiler`` and prints the wall time of that
step, the device's busy time (the sum of its kernels and copies; the step's
``record_function`` spans also appear on the device's side, as intervals
that hold idle gaps, and are left out) and the 12 device kernels that take
most of it. The profiler inflates the wall time, not the device times.
Exits 1 unless the device is a visible CUDA card: the numbers are the card's.
"""

from __future__ import annotations

import subprocess
import sys
import time

WARMUP_STEPS = 20
TOP_KERNELS = 12


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.step import init_train_state, train_step
    from indoor_nerf_tpu_torch.train.trainer import one_batch

    argv = list(sys.argv[1:] if argv is None else argv)
    train_args = [a for a in argv if a != "--"]
    cli = parse_args(train_args)
    if torch.device(cli.device).type != "cuda" or not torch.cuda.is_available():
        print(f"profile_step: --device {cli.device} is no visible CUDA device "
              f"(torch.cuda.is_available() is {torch.cuda.is_available()}); "
              "the numbers are the card's", file=sys.stderr)
        return 1
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
    torch.cuda.synchronize(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(f"profile_step: {smi.stdout.strip().splitlines()[0]}; "
          f"{' '.join(train_args)}; step {state['step']} recorded")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = train_step(state, batch, cfg, gen)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = ("sample", "encode", "mlp", "composite", "tv", "backward",
             "encode_bwd", "optimizer", "occ_update")
    events = prof.key_averages()
    # A span shows up on the device's side too, as an interval that covers
    # its kernels and the gaps between them; only kernels and copies count.
    kernels = [e for e in events
               if e.device_type.name == "CUDA" and e.key not in spans]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_ops = sum(e.count for e in kernels)
    print(f"wall {wall_ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms in "
          f"{n_ops} device operations, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f} (of the profiled wall)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP_KERNELS]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
              f"{e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
