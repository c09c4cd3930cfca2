"""chip_smoke.py refuses to report without a CUDA card, and alone."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke would run")
    proc = _run(_ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def test_exits_nonzero_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
