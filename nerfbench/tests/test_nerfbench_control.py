"""The control, on the card: the reference itself computed one precision
below the configuration's (every matrix product's operands rounded to TF32
where the configuration states float32 with TF32 off) comes out not
correct against the limits,
where the program comes out correct, at each cell's own size with a short
window. Marked ``cuda``; it skips without a card (decided inside the
test). Run on the card with

    python -m pytest -p no:cacheprovider -m cuda nerfbench/tests
"""

import time

import pytest

from nerfbench import catalog, checks, run

CELLS = [w["name"] for w in catalog.Catalog().bench["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_program_passes(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells run on the card")
    cat = catalog.Catalog()
    out = run.run_cell(cat, workload, 2**31 + 12345, 1.0, False, "cuda:0",
                       time.perf_counter(), control=True)
    limits = cat.limits(workload)
    assert out["correct"], out["checks"]
    assert not checks.verdict(out["control_checks"], limits), out["control_checks"]
