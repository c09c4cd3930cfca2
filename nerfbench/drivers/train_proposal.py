"""Nerfacto's training loop: ``train.py``'s loop, its window and its
profiled stretches, with nerfacto's weights, reference and counters.

Traffic keys: those of ``train.py``. The state is put at ``start_step``
with the proposal fields' update counter one past ``proposal_update_every``,
so the first checked step updates them (and, past the warm-up, the next
five do not).

Set-up builds the trainer's state (``program.Training``), loads the
benchmark's weights (``reference/nerfacto.py``'s ``make_params``) and runs
``warmup_steps`` steps through ``train.py``'s loop, the first
``check_steps`` kept for the reference, which replays them
(``reference/nerfacto.py``'s ``run_steps``). The numbers are
``checks.train_numbers``' and ``interlevel1_gap``, the first step's
interlevel loss against the reference's.

Faults (the CPU tests and the card): ``train.py``'s ``unchanged_state``
and ``half_batch``; ``uniform_proposal``, the field's samples drawn from
the initial spacing (the proposal fields' weights replaced by uniform
ones before each draw); ``no_interlevel``, the interlevel term's value
kept and its gradient dropped.

A ``--trace 1`` run profiles ``trace_steps`` steps and reads the program's
counters over them (``program_nerfacto.py``): the samples each field
evaluated and the proposal updates, which give the step's model
operations; the three encodes' least time, forward and backward, comes
from the first traced step's points, replayed by the reference
(``counts_nerfacto.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Dict, List

import torch

from nerfbench import checks, program, program_nerfacto, tracing
from nerfbench import counts_nerfacto
from nerfbench.drivers.train import BETA1, _leaf_norms, _Loop, _profiled, _row_norms
from nerfbench.reference import nerfacto


def _n_train_images(scene_dir: str) -> int:
    with open(os.path.join(scene_dir, "transforms_train.json")) as f:
        return len(json.load(f)["frames"])


def _plant(fault):
    """Break the program's timed path for ``fault``; returns the undo."""
    if fault == "uniform_proposal":
        from indoor_nerf_tpu_torch.render import proposal

        inner = proposal.pdf_edges

        def uniform(edges, weights, n, u, anneal=1.0):
            return inner(edges, torch.ones_like(weights), n, u, anneal)

        proposal.pdf_edges = uniform
        return lambda: setattr(proposal, "pdf_edges", inner)
    if fault == "no_interlevel":
        from indoor_nerf_tpu_torch.train import step

        inner = step.interlevel_loss
        step.interlevel_loss = lambda *a: inner(*a).detach()
        return lambda: setattr(step, "interlevel_loss", inner)
    return None


def run(ctx) -> Dict:
    t = ctx.traffic
    dev = ctx.device
    S0 = int(t["start_step"])
    args = dict(ctx.config["args"])
    args.update(t.get("flags", {}))
    flags = program.cli_flags(args, {"datadir": ctx.scene_dir,
                                     "device": str(dev)})
    t_build = time.perf_counter()
    tr = program.Training(flags, dev, ctx.seed)
    t_built = time.perf_counter()
    spec = nerfacto.make_spec(args, _n_train_images(ctx.scene_dir))
    scale = float(t["table_scale"])
    params0 = nerfacto.make_params(spec, ctx.seed, dev, scale)
    tr.load_params(params0, S0)
    del params0
    since0 = spec.update_every + 1
    tr.state["proposal_since"] = since0
    undo = _plant(ctx.fault)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
    loop = _Loop(tr, gen, ctx.fault)

    n_check = int(t["check_steps"])
    kept, losses = [], []
    for k in range(int(t["warmup_steps"])):
        i = S0 + k + 1
        if k < n_check:
            batch, draws, metrics = loop.step(i, keep=True)
            kept.append(({kk: v.detach().clone() for kk, v in batch.items()},
                         draws))
            losses.append(float(metrics["loss"]))
            if k == 0:
                interlevel1 = float(metrics["interlevel"])
                mu = tr.state["opt"]["mu"]
                grad_prog = _leaf_norms(mu, 1.0 / (1.0 - BETA1))
                rows_prog = _row_norms(mu["table"], 1.0 / (1.0 - BETA1))
            if k == n_check - 1:
                p0 = nerfacto.make_params(spec, ctx.seed, dev, scale)
                leaves = tr.leaves()
                change_prog = {kk: float(torch.linalg.norm(
                    leaves[kk].detach() - p0[kk])) for kk in p0}
                del p0
        else:
            loop.step(i)
    loop.finish()
    next_i = S0 + int(t["warmup_steps"]) + 1
    profile_steps = 0 if ctx.trace else int(t.get("window_profile_steps", 0))
    if profile_steps:  # the profiler's first use, in set-up
        next_i += _profiled(loop, next_i, 2, lambda: True, dev,
                            ctx.trace_path)[0]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    loop.sampler_s = 0.0

    t_setup_end = time.perf_counter()
    print(f"setup: program state and scene {t_built - t_build:.3f} s, "
          f"weights and warm-up steps {t_setup_end - t_built:.3f} s",
          file=sys.stderr)
    steps, busy_s, n_ops = 0, 0.0, 0
    t0 = time.perf_counter()

    def window_open():
        return time.perf_counter() - t0 < ctx.seconds

    if profile_steps:
        while window_open():
            n, busy, ops = _profiled(loop, next_i, profile_steps, window_open,
                                     dev, ctx.trace_path)
            next_i, steps = next_i + n, steps + n
            busy_s, n_ops = busy_s + busy, n_ops + ops
    else:
        while window_open():
            loop.step(next_i)
            next_i += 1
            steps += 1
        loop.finish()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    if profile_steps:
        e2e = {"train_device_ms": 1e3 * busy_s / max(steps, 1)}
        print(f"window: {steps} steps traced whole, {n_ops} device operations "
              f"({n_ops / max(steps, 1):.1f} a step), busy {busy_s:.4f} s of "
              f"{window_s:.3f} s", file=sys.stderr)
    else:
        e2e = {"train_rays_per_s": spec.n_rand * steps / window_s}

    out = {"setup_end": t_setup_end, "attempted": steps, "failed": loop.bad,
           "e2e": e2e, "kind": "train_proposal", "spec": spec, "traffic": t,
           "window": {"seconds": window_s, "units": steps,
                      "unit_wall_s": window_s / max(steps, 1),
                      "sampler_s": loop.sampler_s / max(steps, 1)}}
    if ctx.trace:
        out.update(_trace(ctx, tr, loop, spec, next_i))
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)

    if undo is not None:
        undo()
    tr.free()
    del loop
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_steps(spec, ctx.seed, dev, scale, kept, S0, since0)
    print(f"check: the reference took {time.perf_counter() - t_ref:.3f} s; "
          f"proposal updates on the checked steps {ref['updates']}",
          file=sys.stderr)
    out["checks"] = _numbers(losses, grad_prog, change_prog, rows_prog,
                             interlevel1, ref)
    if getattr(ctx, "control", False):
        low = reference_steps(dataclasses.replace(spec, tf32=True), ctx.seed,
                              dev, scale, kept, S0, since0)
        out["control_checks"] = _numbers(
            low["losses"], low["grad_norms"], low["change_norms"],
            low["table_rows"], low["interlevels"][0], ref)
    return out


def _numbers(losses, grad_norms, change_norms, table_rows, interlevel1,
             ref) -> Dict[str, float]:
    out = checks.train_numbers(
        {"losses": losses, "grad_norms": grad_norms,
         "change_norms": change_norms, "table_rows": table_rows}, ref)
    out["interlevel1_gap"] = (abs(interlevel1 - ref["interlevels"][0])
                              / max(abs(ref["interlevels"][0]), 1e-30))
    return out


def reference_steps(spec, seed: int, dev, table_scale: float, kept: List,
                    S0: int, since0: int) -> Dict:
    """The reference's steps over the kept batches and draws from the
    benchmark's weights at ``S0``, zero moments, ``since0`` steps after the
    proposals' last update; with the change of each leaf."""
    params = nerfacto.make_params(spec, seed, dev, table_scale)
    p0 = {k: v.clone() for k, v in params.items()}
    res = nerfacto.run_steps(params, [b for b, _ in kept],
                             [d for _, d in kept], spec, S0, S0, since0)
    res["change_norms"] = {k: float(torch.linalg.norm(params[k] - p0[k]))
                           for k in params}
    return res


def _trace(ctx, tr, loop, spec, next_i) -> Dict:
    """A profiled stretch of ``trace_steps`` steps, the program's counters
    over it, and the encodes' least time from the first step's points."""
    n = int(ctx.traffic["trace_steps"])
    first = {}

    def work():
        nonlocal next_i
        for k in range(n):
            kept = loop.step(next_i, keep=(k == 0))
            if k == 0:
                first["batch"], first["draws"], _ = kept
                first["params"] = {kk: v.detach().clone()
                                   for kk, v in tr.leaves().items()}
                first["step"] = tr.state["step"] - 1
            next_i += 1
        loop.finish()

    program_nerfacto.reset_counts()
    wall = tracing.profiled(work, ctx.trace_path, tr.device)
    counts = program_nerfacto.sample_counts()
    red = tracing.reduce_trace(ctx.trace_path)
    out = {"trace": dict(red, wall_s=wall, units=n)}
    if not counts:
        return out
    b = first["batch"]
    with torch.no_grad():
        pts = nerfacto.render_rays(first["params"], b["rays_o"], b["rays_d"],
                                   spec, first["step"], first["draws"], False,
                                   b.get("img_idx"))["points"]
    names = [f"proposal_{i}" for i in range(len(spec.proposals))] + ["field"]
    samples = [counts.get(k, 0) / n for k in names]
    share = counts.get("updates", 0) / n
    least = counts_nerfacto.encode_least_seconds(pts, spec)
    out["work"] = {
        "encode_least_s": sum(least),
        "encode_bwd_least_s": counts_nerfacto.encode_bwd_least_seconds(
            least, share),
        "flops_per_unit": counts_nerfacto.step_flops(spec, samples, share),
        "samples_per_step": samples, "update_share": share}
    print(f"trace: samples a step {samples}, proposal update share {share}",
          file=sys.stderr)
    return out
