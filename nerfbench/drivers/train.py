"""The training loop as the trainer runs it, closed loop, with the
benchmark's checks around it.

Traffic keys: ``start_step`` (the step the state is put at: where in a run
the window lies), ``flags`` (schedule flags the mix sets), ``table_scale``
(the table's initial uniform half-width), ``warmup_steps`` (set-up steps,
the checked ones included), ``check_steps`` (how many the reference
follows, from the first), ``trace_steps`` (profiled steps of a ``--trace
1`` run), ``window_profile_steps`` (optional: a ``--trace 0`` window runs
under the profiler, in stretches of that many steps, and gives the
device's busy time a step, ``train_device_ms``, over every step of it; its
host rate is then not given, the profiler slowing the host).

Set-up builds the trainer's state (``program.Training``) on the scene, puts
the benchmark's weights and the step counters into it, and runs
``warmup_steps`` steps through the window's own call: each takes
``make_sampler``'s batch for its step, copied to the device without
blocking, the step's draws (``draw_step``), ``train_step``, and reads the
loss one step late. The first ``check_steps`` record their batches, draws
and losses, the gradient norms the optimizer got in the first (from its
first moments) and the weights' change after the last. The window then
runs the same loop for ``seconds`` and is closed by a synchronize. A
``--trace 1`` run's window is never profiled, so its rate is the host's.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
import time
from typing import Dict, List

import torch
from torch.profiler import record_function

from nerfbench import checks, counts, program, tracing
from nerfbench.reference import model, render, step as ref_step
from nerfbench.reference.spec import blender_bbox, make_spec

BETA1 = 0.9


def _leaf_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0):
    return {k: float(torch.linalg.norm(v.detach().float())) * scale
            for k, v in tensors.items()}


def _row_norms(t: torch.Tensor, scale: float = 1.0):
    """The norm of each row (first axis) of ``t``, on the host."""
    return (torch.linalg.norm(t.detach().float().reshape(t.shape[0], -1), dim=1)
            * scale).cpu().numpy()


def _doubled_table_cotangent():
    """The block-hash encode's backward with every table gradient it
    returns doubled (the planted fault ``table_x2``)."""
    from indoor_nerf_tpu_torch.ops import blockhash

    inner = blockhash.table_scatter

    def doubled(*a, **kw):
        return 2.0 * inner(*a, **kw)

    blockhash.table_scatter = doubled
    return lambda: setattr(blockhash, "table_scatter", inner)


class _Loop:
    """One training iteration at a time, as ``trainer.train`` makes it."""

    def __init__(self, tr: program.Training, gen: torch.Generator, fault=None):
        self.tr, self.gen, self.fault = tr, gen, fault
        self.pending = None
        self.sampler_s = 0.0
        self.bad = 0

    def batch(self, i: int):
        t0 = time.perf_counter()
        with record_function("nerfbench.sampler"):
            b = self.tr.batch(i)
        self.sampler_s += time.perf_counter() - t0
        return b

    def _read(self):
        if self.pending is None:
            return None
        vals, done = self.pending
        if done is not None:
            done.synchronize()
        loss = float(vals[0])
        if not loss == loss or loss in (float("inf"), float("-inf")):
            self.bad += 1
        self.pending = None
        return loss

    def step(self, i: int, keep: bool = False):
        """Step i (the trainer's 1-based index): returns (batch, draws,
        metrics) where ``keep``."""
        tr = self.tr
        with record_function("nerfbench.step"):
            batch = self.batch(i)
            draws = tr.draws(self.gen)
            metrics = self._call(batch, draws)
            self._read()
            vals = torch.stack([metrics["loss"], metrics["psnr"]]).to(
                "cpu", non_blocking=True)
            done = None
            if tr.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
            self.pending = (vals, done)
        return (batch, draws, metrics) if keep else None

    def _call(self, batch, draws):
        if self.fault == "unchanged_state":
            st = self.tr.state
            saved = copy.deepcopy({"params": st["params"], "opt": st["opt"],
                                   "occ": st["occ"], "step": st["step"]})
            metrics = self.tr.step(batch, draws)
            self.tr.state.update(saved)
            return metrics
        if self.fault == "half_batch":
            n = batch["rays_o"].shape[0] // 2
            batch = {k: v[:n] for k, v in batch.items()}
            draws = {k: (v[:n] if k in ("t_rand", "u") else v)
                     for k, v in draws.items()}
            if "priors" in draws:
                draws["priors"] = {k: (v if k == "centers" else v % n)
                                   for k, v in draws["priors"].items()}
        return self.tr.step(batch, draws)

    def finish(self):
        self._read()


def run(ctx) -> Dict:
    t = ctx.traffic
    dev = ctx.device
    S0 = int(t["start_step"])
    args = dict(ctx.config["args"])
    args.update(t.get("flags", {}))
    flags = program.cli_flags(args, {"datadir": ctx.scene_dir,
                                     "device": str(dev)})
    restore = _doubled_table_cotangent() if ctx.fault == "table_x2" else None
    t_build = time.perf_counter()
    tr = program.Training(flags, dev, ctx.seed)
    t_built = time.perf_counter()
    spec = make_spec(args, blender_bbox(ctx.scene_dir)[:2])
    params0 = model.make_params(spec, ctx.seed, dev, float(t["table_scale"]))
    tr.load_params(params0, S0)
    del params0
    gen = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
    loop = _Loop(tr, gen, ctx.fault)

    # Set-up: the checked steps first, then the rest of the warm-up.
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
                mu = tr.state["opt"]["mu"]
                grad_prog = _leaf_norms(mu, 1.0 / (1.0 - BETA1))
                rows_prog = _row_norms(mu["table"], 1.0 / (1.0 - BETA1))
            if k == n_check - 1:
                p0 = model.make_params(spec, ctx.seed, dev, float(t["table_scale"]))
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

    # The window.
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
            n, busy, ops = _profiled(loop, next_i, profile_steps, window_open, dev,
                                     ctx.trace_path)
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
    sampler_s = loop.sampler_s / max(steps, 1)
    if profile_steps:
        e2e = {"train_device_ms": 1e3 * busy_s / max(steps, 1)}
        print(f"window: {steps} steps traced whole, {n_ops} device operations "
              f"({n_ops / max(steps, 1):.1f} a step), busy {busy_s:.4f} s of "
              f"{window_s:.3f} s", file=sys.stderr)
    else:
        e2e = {"train_rays_per_s": spec.n_rand * steps / window_s}

    out = {"setup_end": t_setup_end, "attempted": steps, "failed": loop.bad,
           "e2e": e2e, "kind": "train", "spec": spec, "traffic": t,
           "window": {"seconds": window_s, "units": steps,
                      "unit_wall_s": window_s / max(steps, 1),
                      "sampler_s": sampler_s}}
    if ctx.trace:
        out.update(_trace(ctx, tr, loop, spec, next_i))
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)

    # The check, once the window has closed and the state is freed.
    if restore is not None:
        restore()
    tr.free()
    del loop
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_steps(spec, ctx.seed, dev, float(t["table_scale"]), kept,
                          S0)
    print(f"check: the reference took {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    out["checks"] = checks.train_numbers(
        {"losses": losses, "grad_norms": grad_prog, "change_norms": change_prog,
         "table_rows": rows_prog}, ref)
    if getattr(ctx, "control", False):
        low = reference_steps(dataclasses.replace(spec, tf32=True), ctx.seed,
                              dev, float(t["table_scale"]), kept, S0)
        out["control_checks"] = checks.train_numbers(low, ref)
    return out


def _profiled(loop: _Loop, i: int, n: int, window_open, dev, path: str):
    """Steps ``i``, ``i + 1``, ... under the profiler, up to ``n`` of them
    and while ``window_open()``; returns (steps, the device's busy seconds, its
    operations)."""
    done = [0]

    def work():
        while done[0] < n and window_open():
            loop.step(i + done[0])
            done[0] += 1
        loop.finish()

    busy, ops = tracing.device_busy(work, dev, path)
    return done[0], busy, ops


def reference_steps(spec, seed: int, dev, table_scale: float, kept: List,
                    S0: int) -> Dict:
    """The reference's steps over the kept batches and draws, from the
    benchmark's weights at ``S0`` with zero moments and a full grid: the
    losses, the first gradient's norms and the change's norms per leaf
    (``spec.tf32``: the control)."""
    params = model.make_params(spec, seed, dev, table_scale)
    p0 = {k: v.clone() for k, v in params.items()}
    density = torch.ones(spec.occ_resolution ** 3, device=dev) \
        if spec.occupancy else None
    res = ref_step.run_steps(params, [b for b, _ in kept], [d for _, d in kept],
                             spec, S0, S0, density)
    res["change_norms"] = {k: float(torch.linalg.norm(params[k] - p0[k]))
                           for k in params}
    return res


def _trace(ctx, tr, loop, spec, next_i) -> Dict:
    """A profiled stretch of ``trace_steps`` steps, and the encode's least
    time per step from the first of them's sample points."""
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
                occ = tr.state.get("occ")
                first["density"] = None if occ is None else occ["density"].clone()
                first["step"] = tr.state["step"] - 1
            next_i += 1
        loop.finish()

    path = ctx.trace_path
    wall = tracing.profiled(work, path, tr.device)
    red = tracing.reduce_trace(path)
    b = first["batch"]
    passes = render.sample_points(first["params"], b["rays_o"], b["rays_d"],
                                  spec, first["density"], first["step"],
                                  first["draws"])
    fwd = bwd = 0.0
    for pts in passes:
        touched = counts.touched_count(pts, spec)
        fwd += counts.least_seconds(counts.encode_work(pts.shape[0], touched,
                                                       spec, False))
        bwd += counts.least_seconds(counts.encode_work(pts.shape[0], touched,
                                                       spec, True))
    return {"trace": dict(red, wall_s=wall, units=n),
            "work": {"encode_least_s": fwd, "encode_bwd_least_s": bwd,
                     "flops_per_unit": counts.step_flops(spec, spec.n_rand)}}
