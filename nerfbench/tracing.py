"""The device trace of a profiled stretch of work, reduced.

``profiled(work, path)`` runs ``work()`` under ``torch.profiler`` (CPU and
CUDA activities), closed by a synchronize, and writes the Chrome trace to
``path``; ``device_busy(work)`` profiles the device alone and returns its
busy seconds (a training window traced whole); ``reduce_trace(path)``
reads a Chrome trace back:

- device operations: the events of categories ``kernel``, ``gpu_memcpy``
  and ``gpu_memset``; ``busy_s`` is the time in which one of them ran
  (the union of their intervals);
- each operation's host span: its launch (the runtime call with the same
  ``correlation`` id) and the ``record_function`` spans open on the
  launching thread at that moment, so an operation belongs to a span by
  the launch and not by the span's interval on the device, which holds
  gaps;
- idle gaps: the intervals between consecutive device operations, each
  named by the innermost span open on the host's main thread (the thread
  of the benchmark's own ``nerfbench.*`` spans) when it began.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def profiled(work: Callable[[], None], path: str, device) -> float:
    """Run ``work()`` under the profiler; returns its host seconds (with
    a synchronize at the end) and writes the trace to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        work()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    return wall


def _union_s(intervals: List[Tuple[float, float]], scale: float) -> float:
    """The length of the union of ``(start, end)`` intervals, times
    ``scale``."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        lo = s if end is None else max(s, end)
        if e > lo:
            total += e - lo
        end = e if end is None else max(end, e)
    return total * scale


def device_busy(work: Callable[[], None], device, path: str) -> Tuple[float, int]:
    """Run ``work()`` under the profiler with the device's activities alone,
    closed by a synchronize; returns (busy seconds, device operations): the
    union of the intervals of its kernels, copies and sets. The events are
    read in memory (``path`` takes a Chrome trace only where this torch's
    events carry no activity type). On the CPU: the wall seconds, and 0."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        work()
        return time.perf_counter() - t0, 0
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        work()
        torch.cuda.synchronize(device)
    events = prof.profiler.kineto_results.events()
    if events and hasattr(events[0], "activity_type"):
        iv = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
              if e.activity_type() in DEVICE_CATS]
        return _union_s(iv, 1e-9), len(iv)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    red = reduce_trace(path)
    os.remove(path)
    return red["busy_s"], len(red["ops"])


def _spans_at(annotations: List[Tuple[float, float, str]],
              points: List[Tuple[float, int]]) -> Dict[int, Tuple[str, ...]]:
    """For each ``(ts, key)`` point, the names of the nested spans (start,
    end, name) open at ``ts``, outermost first."""
    events = []
    for s, e, name in annotations:
        events.append((s, 0, name))
        events.append((e, 2, name))
    for ts, key in points:
        events.append((ts, 1, key))
    events.sort(key=lambda x: (x[0], x[1]))
    stack: List[str] = []
    out = {}
    for _, kind, val in events:
        if kind == 0:
            stack.append(val)
        elif kind == 2:
            if val in stack:
                # remove the innermost occurrence
                idx = len(stack) - 1 - stack[::-1].index(val)
                stack.pop(idx)
        else:
            out[val] = tuple(stack)
    return out


def reduce_trace(path: str, main_span_prefix: str = "nerfbench.") -> Dict:
    """``{"ops": [(name, start_us, dur_us, spans)], "busy_s", "gaps":
    [(label, seconds)]}`` of a Chrome trace; ``spans`` are the names of the
    host spans open at each operation's launch."""
    with open(path) as f:
        trace = json.load(f)
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    ops = [e for e in events if e.get("cat") in DEVICE_CATS]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    notes = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation":
            notes[e["tid"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                    e["name"]))
    points = defaultdict(list)
    for i, op in enumerate(ops):
        la = launches.get(op.get("args", {}).get("correlation"))
        if la is not None:
            points[la["tid"]].append((float(la["ts"]), i))
    spans_of: Dict[int, Tuple[str, ...]] = {}
    for tid, pts in points.items():
        spans_of.update(_spans_at(notes.get(tid, []), pts))
    out_ops = [(op["name"], float(op["ts"]), float(op["dur"]), spans_of.get(i, ()))
               for i, op in enumerate(ops)]
    out_ops.sort(key=lambda o: o[1])
    busy_s = _union_s([(ts, ts + dur) for _, ts, dur, _ in out_ops], 1e-6)

    # The main thread: the one that opened the benchmark's own spans.
    main_tid = None
    for tid, ann in notes.items():
        if any(n.startswith(main_span_prefix) for _, _, n in ann):
            main_tid = tid
            break
    gaps = defaultdict(float)
    ann = sorted(notes.get(main_tid, []))
    gap_points = []
    end = None
    for k, (_, ts, dur, _) in enumerate(out_ops):
        if end is not None and ts > end:
            gap_points.append((end, ts - end))
        end = ts + dur if end is None else max(end, ts + dur)
    labels = _spans_at(ann, [(s, k) for k, (s, _) in enumerate(gap_points)])
    for k, (_, g) in enumerate(gap_points):
        lab = labels.get(k, ())
        gaps[lab[-1] if lab else "outside any span"] += g * 1e-6
    return {"ops": out_ops, "busy_s": busy_s,
            "gaps": sorted(gaps.items(), key=lambda x: -x[1])}


def self_time_by_name(ops) -> List[Tuple[str, float]]:
    acc = defaultdict(float)
    for name, _, dur, _ in ops:
        acc[name] += dur * 1e-6
    return sorted(acc.items(), key=lambda x: -x[1])


def under_span(ops, span: str) -> Tuple[int, float]:
    """(count, seconds) of the device operations launched inside ``span``."""
    sel = [o for o in ops if span in o[3]]
    return len(sel), sum(o[2] for o in sel) * 1e-6


def breakdown(red: Dict) -> Dict:
    return {"device_ops": [[n, s] for n, s in self_time_by_name(red["ops"])[:10]],
            "idle_gaps": [[n, s] for n, s in red["gaps"][:10]]}

