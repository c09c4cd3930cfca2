"""The two cells this file's sizes rehearse on the CPU through
``run.run_cell`` (the command itself refuses the CPU): Mip-NeRF 360's
training cell and the guided baked-serving cell, each sound and under
each of its planted faults; ``counts_mipnerf360.py``'s operations; the
new metric readers on made-up traces.

``BENCHMARK.json`` does not list the guided cell yet (its request time
follows the host's speed, PERF.md), so its rehearsal reads a catalog with
the entries that would add it: the cell and the serving metrics' lists.
"""

import copy
import importlib.util
import os
import time
import types

import numpy as np
import pytest

from nerfbench import catalog, counts_mipnerf360, run
from nerfbench.reference import mipnerf360

TINY = {
    "room_mipnerf360.train": {
        "config": {"args": {"netdepth": 5, "netwidth": 64,
                            "prop_netdepth": 2, "prop_netwidth": 32,
                            "bottleneck_width": 16, "netwidth_views": 8,
                            "proposal_samples": "8,8", "nerf_samples": 4,
                            "N_rand": 64},
                   "scene": {"n_views": 8, "H": 24, "W": 24}},
        "traffic": {"warmup_steps": 5, "trace_steps": 3}},
    "room_blockhash.serve_guided": {
        "config": {"args": {"n_levels": 4, "log2_hashmap_size": 12,
                            "finest_res": 32, "occ_resolution": 16,
                            "occ_candidates": 32, "occ_samples": 8},
                   "scene": {"n_views": 8, "H": 24, "W": 24}},
        "traffic": {"width": 24, "height": 20, "baked_res": 16,
                    "check_requests": 2, "trace_requests": 2}},
}
FAULTS = {"room_mipnerf360.train": ["unchanged_state", "half_batch",
                                    "uniform_proposal", "point_ipe",
                                    "no_jacobian"],
          "room_blockhash.serve_guided": ["stale_answer", "short_tile"]}

GUIDED = "room_blockhash.serve_guided"
GUIDED_CELL = {"name": GUIDED, "config": "room_blockhash",
               "traffic": "serve_guided", "chips": 1}
GUIDED_METRICS = ("request_p50_ms", "serve.idle_share",
                  "serve.launches_per_request")


def _catalog():
    """The benchmark's catalog, with the guided cell's entries where
    ``BENCHMARK.json`` lacks them."""
    cat = catalog.Catalog()
    if all(w["name"] != GUIDED for w in cat.bench["workloads"]):
        cat.bench["workloads"].append(GUIDED_CELL)
        for m in cat.bench["end_to_end"] + cat.bench["per_layer"]:
            if m["name"] in GUIDED_METRICS:
                m["workloads"].append(GUIDED)
    return cat


def _run(workload, tmp_path, trace=False, fault=None, control=False):
    return run.run_cell(_catalog(), workload, 2**31 + 4321, 1.0, trace,
                        "cpu", time.perf_counter(),
                        rehearsal=copy.deepcopy(TINY[workload]), fault=fault,
                        cache=str(tmp_path / "cache"), control=control)


@pytest.mark.parametrize("workload", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_new_cell_rehearses(workload, trace, tmp_path):
    out = _run(workload, tmp_path, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    cat = _catalog()
    if not trace:
        assert set(out["metrics"]) == {m["name"]
                                       for m in cat.end_to_end(workload)}
    else:
        assert set(out["metrics"]) <= {m["name"]
                                       for m in cat.per_layer(workload)}
    assert set(out["checks"]) == set(cat.limits(workload))


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in sorted(FAULTS) for f in FAULTS[w]])
def test_new_cell_fault_is_not_correct(workload, fault, tmp_path):
    assert not _run(workload, tmp_path, fault=fault)["correct"]


def test_mipnerf360_control_reads_above_the_sound_run(tmp_path):
    """The TF32 control moves every compared number of the training cell
    off the sound run's."""
    out = _run("room_mipnerf360.train", tmp_path, control=True)
    for k in _catalog().limits("room_mipnerf360.train"):
        assert out["control_checks"][k] > out["checks"][k]["value"], k


def test_mipnerf360_counts():
    spec = mipnerf360.make_spec({}, 500.0)
    prop, nerf = counts_mipnerf360.mlp_flops(spec)
    assert prop == 2 * (72 * 256 + 3 * 256 * 256 + 256)
    trunk = 72 * 1024 + 4 * 1024 * 1024 + 1096 * 1024 + 2 * 1024 * 1024
    assert nerf == 2 * (trunk + 1024 + 1024 * 256 + 283 * 128 + 128 * 3)
    assert 7.78e6 < nerf / 2 < 7.80e6 and 0.21e6 < prop / 2 < 0.22e6
    samples = [16384 * 64, 16384 * 64, 16384 * 32]
    fwd = counts_mipnerf360.forward_flops(spec, samples)
    assert fwd == prop * samples[0] * 2 + nerf * samples[2]
    step = counts_mipnerf360.step_flops(spec, samples)
    assert step == 3 * fwd and 2.7e13 < step < 2.75e13


def _reader(name):
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_mipnerf360_readers():
    ops = [("gemm", 0, 600.0, ("train_step", "proposal", "mlp")),
           ("sin", 0, 100.0, ("train_step", "proposal", "ipe")),
           ("bwd", 0, 300.0, ())]
    run_ = types.SimpleNamespace(
        kind="train_mipnerf360",
        trace={"ops": ops, "units": 2, "busy_s": 1000e-6},
        work={"flops_per_unit": 3e7, "mlp_forward_flops_per_unit": 1e7})
    peak = 67e12
    assert np.isclose(_reader("train_mipnerf360.step_mfu")(run_),
                      100.0 * 3e7 * 2 / (1000e-6 * peak))
    assert np.isclose(_reader("train_mipnerf360.mlp_roofline")(run_),
                      100.0 * 1e7 * 2 / (600e-6 * peak))
    assert np.isclose(_reader("train_mipnerf360.ipe_share")(run_), 10.0)
    assert np.isclose(_reader("train_mipnerf360.proposal_share")(run_),
                      70.0)
    assert _reader("train_mipnerf360.launches_per_step")(run_) == 1.5
    run_.trace = {"ops": ops[2:], "units": 2, "busy_s": 300e-6}
    assert _reader("train_mipnerf360.mlp_roofline")(run_) is None
    assert _reader("train_mipnerf360.ipe_share")(run_) is None
    assert _reader("train_mipnerf360.proposal_share")(run_) is None
    run_.kind = "train_proposal"
    for m in ("step_mfu", "mlp_roofline", "ipe_share", "launches_per_step",
              "proposal_share"):
        assert _reader(f"train_mipnerf360.{m}")(run_) is None
