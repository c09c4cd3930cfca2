"""The readings the correctness limits are set from, on the card.

    python3 -m nerfbench.calibrate --workload <name> --seeds s1,s2,... \\
        [--control N] [--seconds S] [--fault F]

Runs the cell once per seed in this one process (short windows: the
numbers compared come from the set-up's checked steps, or from the
window's requests), prints each run's compared numbers (the lower
readings; every number the driver computes, compared or not), and for the
first ``N`` seeds also the control's: the reference itself computed one
precision below the configuration's (every matrix product's operands
rounded to TF32 where the configuration states float32 with TF32 off),
held to the reference. ``--fault`` runs the program with one of the faults the
tests plant: ``unchanged_state``, ``half_batch`` and ``table_x2`` (the
block-hash table's gradient doubled) in training, ``stale_answer`` and
``short_tile`` in serving.
Writes one JSON line per run to standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from nerfbench import catalog
from nerfbench.run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None)
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cat = catalog.Catalog()
    for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        out = run_cell(cat, a.workload, seed, a.seconds, False, "cuda:0", t0,
                       fault=a.fault, control=i < a.control)
        line = {"workload": a.workload, "seed": seed, "fault": a.fault,
                "correct": out["correct"],
                "program": out["_numbers"],
                "control": out.get("control_checks"),
                "setup_s": out["_setup_s"], "metrics": out["metrics"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
