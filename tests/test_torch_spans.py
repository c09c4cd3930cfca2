"""The port's span recorder (``indoor_nerf_tpu_torch/utils/spans.py``) on
the CPU: the off path calls nothing of the profiler, a profiled run keeps
every span name in its Chrome trace (``encode_bwd`` on another thread under
``backward``), a recorded span lines up with its trace event, the unit and
self-time arithmetic, the request ids of serving, the trainer's print-interval
rate, and the benchmark's readers of the recorder at the tiny sizes."""

import argparse
import ast
import glob
import json
import os
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_parity import CPU, TINY_FLAGSHIP
from indoor_nerf_tpu_torch import serve
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.train.step import init_train_state, train_step
from indoor_nerf_tpu_torch.train.trainer import one_batch, train
from indoor_nerf_tpu_torch.utils import spans
from indoor_nerf_tpu_torch.utils.spans import span

POSE = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4.0]], np.float32)
PACKAGE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "indoor_nerf_tpu_torch")


@pytest.fixture(autouse=True)
def recorder_off():
    """Each test starts and ends with the recorder off and empty."""
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


@pytest.fixture(scope="module")
def step_inputs():
    args = parse_args(TINY_FLAGSHIP + ["--N_rand", "64"] + CPU)
    cfg, batch = one_batch(args, torch.device("cpu"))
    return cfg, batch


def _one_step(cfg, batch, seed=0):
    state = init_train_state(torch.Generator().manual_seed(seed), cfg,
                             torch.device("cpu"))
    return train_step(state, batch, cfg, torch.Generator().manual_seed(seed + 1))


@pytest.fixture(scope="module")
def server():
    """A tiny online server's render function (one warm-up render made)."""
    args = argparse.Namespace(width=16, height=12,
                              train_args=["--"] + TINY_FLAGSHIP + CPU)
    return serve.build(args)


def _span_literals():
    """``(file, name)`` of every ``span("name", ...)`` call in the package."""
    out = []
    for path in glob.glob(os.path.join(PACKAGE, "**", "*.py"), recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "span"):
                assert isinstance(node.args[0], ast.Constant), path
                out.append((os.path.relpath(path, PACKAGE), node.args[0].value))
    return out


def test_names_registry_is_every_span_the_package_opens():
    opened = {name for _, name in _span_literals()}
    assert opened == set(spans.NAMES)
    assert len(spans.NAMES) == len(set(spans.NAMES))
    assert set(spans.UNITS) <= set(spans.NAMES)


def test_record_function_only_in_the_recorder():
    users = []
    for path in glob.glob(os.path.join(PACKAGE, "**", "*.py"), recursive=True):
        with open(path) as f:
            if "record_function" in f.read():
                users.append(os.path.relpath(path, PACKAGE))
    assert users == [os.path.join("utils", "spans.py")]


def _raise(*a, **k):
    raise AssertionError("the profiler was called")


@pytest.mark.parametrize("recorder", ["off", "on"])
def test_no_profiler_call_without_a_profiler(recorder, step_inputs, server,
                                             monkeypatch):
    """Off, a span calls nothing of the profiler and makes no span object;
    on (with no profiler running), it records without calling it either."""
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(spans, "record_function", _raise)
    if recorder == "off":
        monkeypatch.setattr(spans, "Span", _raise)
    else:
        spans.enable()
    cfg, batch = step_inputs
    _, metrics = _one_step(cfg, batch)
    assert torch.isfinite(metrics["loss"])
    render, _, _ = server
    maps, _ = render(POSE)
    assert np.all(np.isfinite(maps["rgb_map"]))
    units = spans.snapshot()["units"]
    assert [u["unit"] for u in units] == (
        [] if recorder == "off" else ["train_step", "request"])


def _chrome_trace(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)


def _profile_all_threads():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=torch._C._profiler._ExperimentalConfig(
                       profile_all_threads=True))


def test_profiled_names_reach_the_trace(step_inputs, server, tmp_path):
    """Under a CPU profiler every span keeps its name in the Chrome trace,
    with the recorder on or off; ``encode_bwd`` opened on another thread
    (as autograd's worker thread opens it on the card) is recorded with
    the parent ``backward``."""
    cfg, batch = step_inputs
    render, _, _ = server
    _one_step(cfg, batch)  # warm
    for recorder in (False, True):
        spans.reset()
        if recorder:
            spans.enable()
        with _profile_all_threads() as prof:
            _one_step(cfg, batch)
            render(POSE)
            with span("backward"):
                worker = threading.Thread(target=lambda: span(
                    "encode_bwd").__enter__().__exit__(None, None, None))
                worker.start()
                worker.join(timeout=60)
            assert not worker.is_alive()
        spans.disable()
        events = [e for e in _chrome_trace(prof, tmp_path)["traceEvents"]
                  if e.get("cat") == "user_annotation"]
        names = {e["name"] for e in events}
        assert names >= {"train_step", "draw", "sample", "encode", "mlp",
                         "composite", "tv", "backward", "encode_bwd",
                         "optimizer", "occ_update", "request", "queue",
                         "render", "drain", "copy"}
        main = threading.get_native_id()
        assert any(e["name"] == "encode_bwd" and e["tid"] != main
                   for e in events)
        recorded = spans.snapshot()["spans"]
        if not recorder:
            assert recorded == []
            continue
        threaded = [s for s in recorded if s[0] == "encode_bwd" and s[2] != main]
        assert len(threaded) == 1 and threaded[0][1] == "backward"
        # On the CPU the encode's backward runs on the calling thread.
        assert ("encode_bwd", "backward") in {(s[0], s[1]) for s in recorded
                                              if s[2] == main}


def test_recorded_start_lines_up_with_the_trace(step_inputs, tmp_path):
    cfg, batch = step_inputs
    _one_step(cfg, batch)  # warm
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _one_step(cfg, batch)
    spans.disable()
    trace = _chrome_trace(prof, tmp_path)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    events = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            events.setdefault(e["name"], []).append(float(e["ts"]) + base_us)
    recorded = spans.snapshot()["spans"]
    assert {s[0] for s in recorded} >= {"train_step", "encode", "backward"}
    for name, _, _, start, end, _ in recorded:
        gap_us = min(abs(start / 1e3 - ts) for ts in events[name])
        assert gap_us < 100.0, (name, gap_us)  # 0.1 ms
        assert end > start


class _Clock:
    """``time.time_ns`` stepped by hand."""

    def __init__(self):
        self.now = 10 ** 18

    def time_ns(self):
        return self.now

    def at(self, t):
        self.now = 10 ** 18 + t


def test_unit_and_self_time_arithmetic(monkeypatch):
    """Two units on a hand clock: the spans before a unit count in it, a
    span's self time is its duration less the union of its children's
    intervals (overlapping children on two threads counted once), and a
    name seen twice in a unit sums."""
    clock = _Clock()
    monkeypatch.setattr(spans, "time", clock)
    spans.reset()
    spans.enable()

    def interval(name, t0, t1, inner=()):
        clock.at(t0)
        with span(name):
            for f in inner:
                f()
            clock.at(t1)

    # unit 1: sampler [0, 10], draw [10, 15], then train_step [20, 100]
    # with sample [25, 30] and [35, 45], backward [50, 90] holding
    # encode_bwd [55, 70] here and [60, 80] on another thread.
    interval("sampler", 0, 10)
    interval("draw", 10, 15)

    def worker():
        clock.at(60)
        with span("encode_bwd"):
            clock.at(80)

    def backward():
        def inner():
            interval("encode_bwd", 55, 70)
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
        interval("backward", 50, 90, [inner])

    interval("train_step", 20, 100, [lambda: interval("sample", 25, 30),
                                     lambda: interval("sample", 35, 45),
                                     backward])
    # unit 2: train_step [200, 230] alone.
    interval("train_step", 200, 230)
    snap = spans.snapshot()
    u1, u2 = snap["units"]
    assert u1["unit"] == u2["unit"] == "train_step"
    assert u1["start_ns"] == clock.now - 230 and u1["end_ns"] - u1["start_ns"] == 100
    assert u1["total_ns"] == {"sampler": 10, "draw": 5, "train_step": 80,
                              "sample": 15, "backward": 40, "encode_bwd": 35}
    assert u1["self_ns"] == {"sampler": 10, "draw": 5,
                             "train_step": 80 - 15 - 40, "sample": 15,
                             "backward": 40 - 25, "encode_bwd": 35}
    assert u2["total_ns"] == u2["self_ns"] == {"train_step": 30}
    assert snap["totals"]["train_step"] == {"count": 2, "total_ns": 110,
                                            "self_ns": 55}
    assert snap["totals"]["sample"] == {"count": 2, "total_ns": 15,
                                        "self_ns": 15}
    assert snap["totals"]["encode_bwd"]["count"] == 2
    # reset drops the ring, the totals and the spans waiting for a unit.
    interval("sampler", 300, 310)
    spans.reset()
    interval("train_step", 400, 410)
    assert [u["total_ns"] for u in spans.snapshot()["units"]] == [
        {"train_step": 10}]


def test_ring_is_bounded(monkeypatch):
    monkeypatch.setattr(spans, "_units", spans.collections.deque(maxlen=3))
    spans.enable()
    for _ in range(5):
        with span("train_step"):
            pass
    snap = spans.snapshot()
    assert len(snap["units"]) == 3 and snap["totals"]["train_step"]["count"] == 5


def test_serving_spans_carry_request_ids(server):
    render, _, _ = server
    spans.enable()
    render(POSE)
    render(POSE, request_id=77)
    render(POSE)
    snap = spans.snapshot()
    ids = [u["ids"]["request"] for u in snap["units"]]
    assert ids[1] == 77 and ids[2] == ids[0] + 1
    for u in snap["units"]:
        assert u["unit"] == "request"
        assert set(u["total_ns"]) >= {"request", "queue", "render", "drain",
                                      "copy", "sample", "encode", "mlp"}
        assert u["total_ns"]["request"] >= sum(
            u["total_ns"][k] for k in ("queue", "render", "drain", "copy"))
    by_id = {}
    for name, _, _, _, _, rid in snap["spans"]:
        by_id.setdefault(rid["request"], set()).add(name)
    assert set(by_id) == set(ids)
    assert all(names >= {"request", "copy", "encode"} for names in by_id.values())


def test_render_answers_carry_the_request_id(server):
    render, step, hw = server
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(render, step, hw))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        spans.enable()
        got = []
        for _ in range(2):
            with urllib.request.urlopen(
                    base + "/render?theta=10&phi=-20&radius=4", timeout=120) as r:
                assert r.headers["Content-Type"] == "image/png"
                got.append(int(r.headers["X-Request-Id"]))
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            assert r.headers["X-Request-Id"] is None
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert got[1] == got[0] + 1
    assert [u["ids"]["request"] for u in spans.snapshot()["units"]] == got


def test_trainer_rate_is_per_print_interval():
    """``iterations_per_second`` holds one rate a print interval (the steps
    over the seconds between two print steps' loss reads), with the steps
    it covers; the trainer's batches are ``batch`` spans holding the
    ``sampler``'s."""
    spans.enable()
    out = train(parse_args(TINY_FLAGSHIP + CPU + [
        "--N_rand", "64", "--n_iters", "12", "--i_print", "4"]))
    spans.disable()
    ips = out["iterations_per_second"]
    assert out["iterations_per_second_steps"] == [[1, 4], [5, 8], [9, 12]]
    assert len(ips) == 3 and all(np.isfinite(ips)) and min(ips) > 0
    units = spans.snapshot()["units"]
    assert len(units) == 12
    for u in units:
        assert u["total_ns"]["batch"] >= u["total_ns"]["sampler"] > 0
        assert u["self_ns"]["batch"] == (u["total_ns"]["batch"]
                                         - u["total_ns"]["sampler"])


# The span that gives each cell's host split (PERF.md, "Where the time
# goes"), one per layer a cell exercises on the host.
CELL_SPANS = [
    ("room_blockhash.train", "train_step"),
    ("room_blockhash.train", "backward"),
    ("room_hashgrid.train", "train_step"),
    ("room_hashgrid.train", "backward"),
    ("room_blockhash.train_priors", "train_step"),
    ("room_blockhash.train_priors", "priors"),
    ("room_blockhash.train_priors", "sampler"),
    ("room_blockhash.serve", "copy"),
]


def _rehearse(workload, cache):
    """One ``--trace 1`` rehearsal of ``workload`` at the tiny sizes."""
    from nerfbench import catalog, run
    from nerfbench.tests._tiny import tiny

    return run.run_cell(catalog.Catalog(), workload, 2**31 + 5, 0.5, True,
                        "cpu", time.perf_counter(), rehearsal=tiny(workload),
                        cache=cache)


@pytest.fixture(scope="module")
def recorded_cells(tmp_path_factory):
    """``(result, snapshot)`` of one rehearsal of each cell, the recorder on
    from set-up to the end of the check."""
    cache = str(tmp_path_factory.mktemp("bench") / "cache")
    done = {}

    def get(workload):
        if workload not in done:
            spans.reset()
            spans.enable()
            try:
                out = _rehearse(workload, cache)
            finally:
                spans.disable()
            done[workload] = (out, spans.snapshot())
        return done[workload]

    return get


@pytest.mark.parametrize("workload,name", CELL_SPANS)
def test_benchmark_cell_records_its_host_split(workload, name, recorded_cells):
    """Through the benchmark's own loop (``nerfbench.program``), every step
    or request is one unit, and each holds the cell's host spans."""
    out, snap = recorded_cells(workload)
    assert out["correct"]
    unit = "request" if workload.endswith(".serve") else "train_step"
    units = [u for u in snap["units"] if u["unit"] == unit]
    assert len(units) >= out["attempted"] > 0
    assert all(u["total_ns"].get(name, 0) > 0 for u in units)
    for u in units:
        assert u["end_ns"] - u["start_ns"] >= u["total_ns"][unit]
        assert u["total_ns"][unit] >= u["total_ns"][name]
        assert 0 <= u["self_ns"][name] <= u["total_ns"][name]


def test_benchmark_leaves_the_recorder_off(tmp_path):
    """A traced run of the benchmark switches the recorder on nowhere: its
    untraced window runs as with no recorder, and its line holds the
    accepted benchmark's per-layer metrics and no other."""
    from nerfbench import catalog

    out = _rehearse("room_blockhash.train_priors", str(tmp_path / "cache"))
    assert out["correct"]
    assert not spans._on and spans.snapshot()["units"] == []
    listed = {m["name"] for m in catalog.Catalog().per_layer(
        "room_blockhash.train_priors")}
    assert set(out["metrics"]) <= listed
