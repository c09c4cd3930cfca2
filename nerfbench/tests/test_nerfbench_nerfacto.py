"""The two cells this file's sizes rehearse on the CPU through
``run.run_cell`` (the command itself refuses the CPU): nerfacto's training
cell and the baked-serving cell, each sound and under each of its planted
faults; and ``counts_nerfacto.py``'s touched-entry count against brute
force. The sizes live here: ``_tiny.py``'s serve the older cells."""

import copy
import time

import numpy as np
import pytest
import torch

from nerfbench import catalog, counts, counts_nerfacto, run
from nerfbench.reference import grid, nerfacto

TINY = {
    "room_nerfacto.train": {
        "config": {"args": {"n_levels": 4, "log2_hashmap_size": 10,
                            "finest_res": 32,
                            "proposal_log2_hashmap_size": 10,
                            "proposal_samples": "16,8", "nerf_samples": 8,
                            "N_rand": 64},
                   "scene": {"n_views": 8, "H": 24, "W": 24}},
        "traffic": {"warmup_steps": 5, "trace_steps": 3}},
    "room_blockhash.serve_baked": {
        "config": {"args": {"n_levels": 4, "log2_hashmap_size": 12,
                            "finest_res": 32, "occ_resolution": 16,
                            "occ_candidates": 32, "occ_samples": 8},
                   "scene": {"n_views": 8, "H": 24, "W": 24}},
        "traffic": {"width": 24, "height": 20, "baked_res": 16,
                    "check_requests": 2, "trace_requests": 2}},
}
FAULTS = {"room_nerfacto.train": ["unchanged_state", "half_batch",
                                  "uniform_proposal", "no_interlevel"],
          "room_blockhash.serve_baked": ["stale_answer", "short_tile"]}


def _run(workload, tmp_path, trace=False, fault=None):
    return run.run_cell(catalog.Catalog(), workload, 2**31 + 4321, 1.0, trace,
                        "cpu", time.perf_counter(),
                        rehearsal=copy.deepcopy(TINY[workload]), fault=fault,
                        cache=str(tmp_path / "cache"))


@pytest.mark.parametrize("workload", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_new_cell_rehearses(workload, trace, tmp_path):
    out = _run(workload, tmp_path, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    cat = catalog.Catalog()
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


def _brute(x, g):
    seen = set()
    for pt in x:
        rows, _ = grid.hash_corners(pt[None], g)
        seen.update(int(r) for r in rows.reshape(-1))
    return len(seen)


def test_nerfacto_counts_match_brute_force():
    spec = nerfacto.make_spec({"n_levels": 3, "log2_hashmap_size": 9,
                               "finest_res": 64, "proposal_levels": 2,
                               "proposal_log2_hashmap_size": 8}, 4)
    gen = torch.Generator().manual_seed(0)
    x = nerfacto.contract(torch.randn((300, 3), generator=gen) * 3)
    for g in counts_nerfacto.grids(spec):
        assert counts_nerfacto.touched_count(x, g, block=64) == _brute(x, g)
    table = torch.rand(spec.field.table_shape, generator=gen)
    t0 = time.perf_counter()
    grid.hash_encode(x, table, spec.field)
    sec = time.perf_counter() - t0
    work = counts_nerfacto.encode_work(
        x.shape[0], counts_nerfacto.touched_count(x, spec.field), spec.field)
    assert 0 < counts.least_seconds(work) <= sec
    least = counts_nerfacto.encode_least_seconds([x, x, x], spec)
    assert least[-1] == counts.least_seconds(work)
    assert counts_nerfacto.encode_bwd_least_seconds(least, 0.0) == least[-1]
    assert np.isclose(counts_nerfacto.encode_bwd_least_seconds(least, 0.25),
                      least[-1] + 0.25 * (least[0] + least[1]))
    flops = counts_nerfacto.step_flops(spec, [100, 50, 20], 1.0 / 6)
    assert flops > counts_nerfacto.step_flops(spec, [100, 50, 20], 0.0) > 0
    assert np.isclose(counts_nerfacto.mlp_flops(spec)[-1],
                      2 * (6 * 64 + 64 * 16 + 63 * 64 + 64 * 64 + 64 * 3))


def test_encode_bwd_roofline_reads_the_encode_bwd_span():
    """The reader takes the device time of the operations launched under
    ``encode_bwd`` a step, and nothing where the span launched none."""
    import importlib.util
    import os
    import types

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "metrics",
                        "train_proposal.encode_bwd_roofline.py")
    spec = importlib.util.spec_from_file_location("encode_bwd_reader", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    ops = [("a", 0, 300.0, ("train_step", "backward", "encode_bwd")),
           ("b", 0, 100.0, ("train_step", "backward", "encode_bwd")),
           ("c", 0, 900.0, ("train_step", "backward"))]
    run_ = types.SimpleNamespace(kind="train_proposal",
                                 trace={"ops": ops, "units": 4},
                                 work={"encode_bwd_least_s": 5e-5})
    assert np.isclose(reader.read(run_), 100.0 * 5e-5 * 4 / 400e-6)
    run_.trace = {"ops": ops[2:], "units": 4}
    assert reader.read(run_) is None
    run_.kind = "train"
    assert reader.read(run_) is None
