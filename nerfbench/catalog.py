"""What ``BENCHMARK.json`` names, found by name in the benchmark's own files.

- a configuration: ``configs/<name>.json`` (the file its entry names);
- a traffic mix: ``traffic/<name>.json``, whose ``driver`` names the
  general loop that reads it (``drivers/<driver>.py``);
- a cell's correctness limits: ``limits/<workload>.json``;
- a per-layer metric: ``metrics/<name>.py``, a reader with ``read(run)``
  that returns the metric's value or None where the run holds nothing to
  read.

A new configuration, mix or metric is new files and new entries only.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Catalog:
    def __init__(self, root: str = ROOT, bench_dir: str = HERE):
        self.root, self.dir = root, bench_dir
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def _json(self, *parts: str) -> Dict:
        with open(os.path.join(self.dir, *parts)) as f:
            return json.load(f)

    def workload(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, workload: str) -> Dict[str, float]:
        return self._json("limits", f"{workload}.json")["limits"]

    def end_to_end(self, workload: str) -> List[Dict]:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]

    def per_layer(self, workload: str) -> List[Dict]:
        reported = {m["name"] for m in self.end_to_end(workload)}
        out = []
        for m in self.bench["per_layer"]:
            if ("workloads" in m and workload in m["workloads"]) or (
                    "workloads" not in m and m["moves"] in reported):
                out.append(m)
        return out

    def reader(self, metric: str):
        path = os.path.join(self.dir, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            "nerfbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

