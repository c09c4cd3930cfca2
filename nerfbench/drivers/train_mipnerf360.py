"""Mip-NeRF 360's training loop: ``train.py``'s loop, its window and its
profiled stretches, with Mip-NeRF 360's weights, reference and counters.

Traffic keys: those of ``train.py``.

Set-up builds the trainer's state (``program.Training``), loads the
benchmark's weights (``reference/mipnerf360.py``'s ``make_params``) and
runs ``warmup_steps`` steps through ``train.py``'s loop, the first
``check_steps`` kept for the reference, which replays them
(``reference/mipnerf360.py``'s ``run_steps``) once the window has closed
and the program's state is freed. The numbers are
``checks.train_numbers``' (its ``table_row`` numbers over the rows of
the NeRF MLP's first layer, one an IPE feature) and ``interlevel1_gap``,
the first step's interlevel loss against the reference's.

Faults (the CPU tests and the card): ``train.py``'s ``unchanged_state``
and ``half_batch``; ``uniform_proposal``, every level's intervals drawn
from uniform weights; ``point_ipe``, the IPE with the Gaussians'
variances set to 0 (the plain PE of their means); ``no_jacobian``, the
covariance left as it is through the contraction.

A ``--trace 1`` run profiles ``trace_steps`` steps and reads the
program's counters over them (``program_nerfacto.py``: the samples each
level evaluated), which give the step's model operations and the nets'
forward operations (``counts_mipnerf360.py``).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List

import torch

from nerfbench import checks, counts_mipnerf360, program, program_nerfacto
from nerfbench import tracing
from nerfbench.drivers.train import BETA1, _leaf_norms, _Loop, _profiled, _row_norms
from nerfbench.reference import mipnerf360
from nerfbench.reference.spec import blender_bbox

FIRST_LAYER = "nerf_mlp.trunk.0.w"


def _plant(fault):
    """Break the program's timed path for ``fault``; returns the undo."""
    from indoor_nerf_tpu_torch.render import proposal

    if fault == "uniform_proposal":
        name, inner = "sample_intervals", proposal.sample_intervals

        def patched(edges, weights, n, u):
            return inner(edges, torch.ones_like(weights), n, u)
    elif fault == "point_ipe":
        name, inner = "integrated_pos_enc", proposal.integrated_pos_enc

        def patched(mean, var, n_degrees):
            return inner(mean, torch.zeros_like(var), n_degrees)
    elif fault == "no_jacobian":
        name, inner = "contract_gaussian", proposal.contract_gaussian

        def patched(mean, rays_d, t_var, r_var):
            d = rays_d[:, None, :]
            c = t_var - r_var / torch.sum(d * d, dim=-1)
            diag = r_var[..., None] + c[..., None] * d * d
            return inner(mean, rays_d, t_var, r_var)[0], diag
    else:
        return None
    setattr(proposal, name, patched)
    return lambda: setattr(proposal, name, inner)


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
    spec = mipnerf360.make_spec(args, blender_bbox(ctx.scene_dir)[2])
    params0 = mipnerf360.make_params(spec, ctx.seed, dev)
    tr.load_params(params0, S0)
    del params0
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
                rows_prog = _row_norms(mu[FIRST_LAYER], 1.0 / (1.0 - BETA1))
            if k == n_check - 1:
                p0 = mipnerf360.make_params(spec, ctx.seed, dev)
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
           "e2e": e2e, "kind": "train_mipnerf360", "spec": spec, "traffic": t,
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
    ref = reference_steps(spec, ctx.seed, dev, kept, S0)
    print(f"check: the reference took {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    out["checks"] = _numbers(losses, grad_prog, change_prog, rows_prog,
                             interlevel1, ref)
    if getattr(ctx, "control", False):
        low = reference_steps(dataclasses.replace(spec, tf32=True), ctx.seed,
                              dev, kept, S0)
        out["control_checks"] = _numbers(
            low["losses"], low["grad_norms"], low["change_norms"],
            low["table_rows"], low["interlevels"][0], ref)
    return out


def _numbers(losses, grad_norms, change_norms, rows, interlevel1,
             ref) -> Dict[str, float]:
    out = checks.train_numbers(
        {"losses": losses, "grad_norms": grad_norms,
         "change_norms": change_norms, "table_rows": rows}, ref)
    out["interlevel1_gap"] = (abs(interlevel1 - ref["interlevels"][0])
                              / max(abs(ref["interlevels"][0]), 1e-30))
    return out


def reference_steps(spec, seed: int, dev, kept: List, S0: int) -> Dict:
    """The reference's steps over the kept batches and draws from the
    benchmark's weights at ``S0`` and zero moments, with the change of each
    leaf."""
    params = mipnerf360.make_params(spec, seed, dev)
    p0 = {k: v.clone() for k, v in params.items()}
    res = mipnerf360.run_steps(params, [b for b, _ in kept],
                               [d for _, d in kept], spec, S0)
    res["change_norms"] = {k: float(torch.linalg.norm(params[k] - p0[k]))
                           for k in params}
    return res


def _trace(ctx, tr, loop, spec, next_i) -> Dict:
    """A profiled stretch of ``trace_steps`` steps and the program's
    counters over it."""
    n = int(ctx.traffic["trace_steps"])

    def work():
        nonlocal next_i
        for _ in range(n):
            loop.step(next_i)
            next_i += 1
        loop.finish()

    program_nerfacto.reset_counts()
    wall = tracing.profiled(work, ctx.trace_path, tr.device)
    counts = program_nerfacto.sample_counts()
    red = tracing.reduce_trace(ctx.trace_path)
    out = {"trace": dict(red, wall_s=wall, units=n)}
    if not counts:
        return out
    names = [f"proposal_{i}" for i in range(len(spec.proposal_samples))]
    samples = [counts.get(k, 0) / n for k in names + ["field"]]
    out["work"] = {
        "flops_per_unit": counts_mipnerf360.step_flops(spec, samples),
        "mlp_forward_flops_per_unit": counts_mipnerf360.forward_flops(
            spec, samples),
        "samples_per_step": samples}
    print(f"trace: samples a step {samples}", file=sys.stderr)
    return out
