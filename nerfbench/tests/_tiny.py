"""The CPU rehearsal's sizes: every cell's configuration and mix cut to a
few views of 24 x 24 pixels, 4 grid levels and 64 rays, so a run takes
about a second on the CPU. The widths of the benchmark's cells are never
cut; these sizes exist for the tests alone."""

import copy

TINY = {
    "config": {"args": {"n_levels": 4, "log2_hashmap_size": 12,
                        "finest_res": 32, "occ_resolution": 16,
                        "occ_candidates": 32, "occ_samples": 8, "N_rand": 64,
                        "N_samples": 8},
               "scene": {"n_views": 8, "H": 24, "W": 24}},
    "traffic": {"warmup_steps": 5, "trace_steps": 3, "width": 16,
                "height": 16, "check_requests": 2, "trace_requests": 2},
}


def tiny(workload: str) -> dict:
    t = copy.deepcopy(TINY)
    if "hashgrid" in workload:
        t["config"]["args"]["N_importance"] = 8
    return t
