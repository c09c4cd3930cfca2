"""Each traffic mix's loop rehearsed on the CPU at the tiny sizes of
``_tiny.py``, through ``run.run_cell`` (the command itself refuses the
CPU): a sound run is correct, and a run with the timed path broken
underneath is not, once for each fault a cell can have. Importing and
rehearsing the harness loads nothing of JAX or the JAX package, and the
reference loads nothing of the program."""

import json
import os
import subprocess
import sys
import time

import pytest

from nerfbench import catalog, run
from nerfbench.tests._tiny import tiny

REPO = catalog.ROOT
CELLS = [w["name"] for w in catalog.Catalog().bench["workloads"]]


def _run(workload, tmp_path, trace=False, fault=None):
    return run.run_cell(catalog.Catalog(), workload, 2**31 + 99, 1.0, trace,
                        "cpu", time.perf_counter(), rehearsal=tiny(workload),
                        fault=fault, cache=str(tmp_path / "cache"))


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_rehearses(workload, trace, tmp_path):
    out = _run(workload, tmp_path, trace)
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    cat = catalog.Catalog()
    if not trace:
        want = {m["name"] for m in cat.end_to_end(workload)}
        assert set(out["metrics"]) == want
    else:
        assert set(out["metrics"]) <= {m["name"] for m in cat.per_layer(workload)}
        assert "busy_s" in out["device"] and "breakdown" in out
    assert list(out)[-3:] == ["checks", "_setup_s", "_numbers"]
    assert set(out["checks"]) == set(cat.limits(workload))


TRAIN_FAULTS = ["unchanged_state", "half_batch"]
SERVE_FAULTS = ["stale_answer", "short_tile"]


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS if "train" in w for f in TRAIN_FAULTS]
    + [(w, "table_x2") for w in CELLS if "blockhash.train" in w]
    + [(w, f) for w in CELLS if "serve" in w for f in SERVE_FAULTS])
def test_fault_is_not_correct(workload, fault, tmp_path):
    out = _run(workload, tmp_path, fault=fault)
    assert not out["correct"]


def _modules_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=REPO))
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax(tmp_path):
    code = (
        "import json, sys, time\n"
        "from nerfbench import catalog, run\n"
        "from nerfbench.tests._tiny import tiny\n"
        f"for w in {CELLS!r}:\n"
        "    run.run_cell(catalog.Catalog(), w, 7, 0.2, w.endswith('serve'),"
        " 'cpu', time.perf_counter(), rehearsal=tiny(w),"
        f" cache={str(tmp_path / 'cache')!r})\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    assert _modules_after(code) == []


def test_reference_loads_nothing_of_the_program():
    code = ("import json, sys\n"
            "import nerfbench.reference.step, nerfbench.reference.priors\n"
            "import nerfbench.counts, nerfbench.checks, nerfbench.scene\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
            " in ('indoor_nerf_tpu_torch', 'indoor_nerf_tpu', 'jax'))))\n")
    assert _modules_after(code) == []


def test_forbidden_names_compare_whole():
    import indoor_nerf_tpu_torch  # noqa: F401  (the port: allowed)

    assert "indoor_nerf_tpu_torch" in sys.modules
    assert run.forbidden_modules() == []
