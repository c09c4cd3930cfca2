"""BENCHMARK.json and the benchmark's files: every file parses, every cell
resolves, the file keeps to the benchmark's contract, and a configuration,
a traffic mix and a per-layer metric are added by new files and new
entries alone."""

import json
import os
import re
import shutil
import time

import pytest

from nerfbench import catalog, run
from nerfbench.tests._tiny import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def cat():
    return catalog.Catalog()


def test_every_file_parses(cat):
    for sub in ("configs", "traffic", "limits"):
        d = os.path.join(catalog.HERE, sub)
        for f in os.listdir(d):
            with open(os.path.join(d, f)) as fh:
                json.load(fh)
    for f in os.listdir(os.path.join(catalog.HERE, "metrics")):
        if f.endswith(".py"):
            assert callable(cat.reader(f[:-3]))


def test_every_cell_resolves(cat):
    b = cat.bench
    for w in b["workloads"]:
        cfg = cat.config(w["config"])
        assert "args" in cfg and "scene" in cfg
        t = cat.traffic(w["traffic"])
        assert os.path.exists(os.path.join(catalog.HERE, "drivers",
                                           t["driver"] + ".py"))
        assert cat.limits(w["name"])
        assert any(m["name"] == "setup_s" for m in cat.end_to_end(w["name"]))
        assert len(cat.end_to_end(w["name"])) >= 2
        assert cat.per_layer(w["name"])
        for m in cat.per_layer(w["name"]):
            cat.reader(m["name"])


def test_contract_shape(cat):
    b = cat.bench
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["nerfbench"] and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("nerfbench/") and len(c["source"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    n = len(b["workloads"])
    # A full check with 24 cells must fit the budget.
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(b)) < 64 * 1024 and n <= 24


def test_new_files_add_a_cell(tmp_path):
    """A dummy configuration, mix and metric, as new files and new entries
    in a copy of the benchmark, run without an edit to any file that is
    there."""
    root = tmp_path / "root"
    shutil.copytree(catalog.HERE, root / "nerfbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(os.path.join(catalog.ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "nerfbench/configs/room_blockhash.json").read_text())
    cfg["args"]["occ_samples"] = 16
    (root / "nerfbench/configs/dummy_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "nerfbench/traffic/train.json").read_text())
    mix["start_step"] = 2048
    (root / "nerfbench/traffic/dummy_mix.json").write_text(json.dumps(mix))
    (root / "nerfbench/metrics/dummy.window_steps.py").write_text(
        "def read(run):\n    return run.window['units']\n")
    (root / "nerfbench/limits/dummy_cfg.dummy_mix.json").write_text(
        (root / "nerfbench/limits/room_blockhash.train.json").read_text())
    bench["configs"].append({"name": "dummy_cfg", "source": "a test",
                             "file": "nerfbench/configs/dummy_cfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy_cfg.dummy_mix",
                               "config": "dummy_cfg", "traffic": "dummy_mix",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_rays_per_s":
            m["workloads"].append("dummy_cfg.dummy_mix")
    bench["per_layer"].append({"name": "dummy.window_steps", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves": "train_rays_per_s",
                               "workloads": ["dummy_cfg.dummy_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cat = catalog.Catalog(str(root), str(root / "nerfbench"))
    t = tiny("dummy_cfg.dummy_mix")
    out = run.run_cell(cat, "dummy_cfg.dummy_mix", 2**31 + 5, 0.3, True,
                       "cpu", time.perf_counter(), rehearsal=t,
                       cache=str(tmp_path / "cache"))
    assert out["correct"]
    assert out["metrics"]["dummy.window_steps"]["value"] >= 1
    changed = [p for p, b in before.items()
               if p.name != "BENCHMARK.json" and p.read_bytes() != b]
    assert changed == []
