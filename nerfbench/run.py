"""Run one cell of the benchmark once.

    python3 -m nerfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json`` (a configuration under a traffic
mix); everything it needs is found by name (``catalog.py``). The run
builds the cell on ``cuda:0`` (set-up: the scene from the cache, the
program's state, the warm-up and the checked steps or the server's build),
measures for ``--seconds``, checks what the timed path produced against the
plain reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, ``build_s`` (the seconds of ``setup_s`` that
``nvcc`` took to build the port's kernels: a new checkout's first run
compiles, later ones load), and last ``checks``: each compared number
beside its limit, which also close standard error.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), and where ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``indoor_nerf_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, Optional  # noqa: E402

from nerfbench import catalog, checks, program, scene  # noqa: E402

CACHE = scene.CACHE_DIR
FORBIDDEN = ("jax", "jaxlib", "flax", "indoor_nerf_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``indoor_nerf_tpu_torch`` is not ``indoor_nerf_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _merge(base: Dict, over: Optional[Dict]) -> Dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def cell_context(cat: catalog.Catalog, workload: str, seed: int,
                 seconds: float, trace: bool, device,
                 rehearsal: Optional[Dict] = None, fault: Optional[str] = None,
                 cache: str = CACHE, control: bool = False):
    """(the mix's driver module, the run's context) of one run of
    ``workload``; the context holds the configuration and the mix, with
    ``rehearsal``'s keys over them."""
    import torch

    w = cat.workload(workload)
    config = _merge(cat.config(w["config"]), (rehearsal or {}).get("config"))
    traffic = _merge(cat.traffic(w["traffic"]), (rehearsal or {}).get("traffic"))
    ctx = SimpleNamespace(
        config=config, traffic=traffic, seed=int(seed), seconds=float(seconds),
        trace=bool(trace), device=torch.device(device), fault=fault,
        control=control,
        scene_dir=scene.scene_dir(config["scene"], cache),
        trace_path=os.path.join(cache, "trace", f"{workload}.json"),
        ckpt_path=os.path.join(cache, "serve", f"{w['config']}.ckpt"))
    return importlib.import_module(f"nerfbench.drivers.{traffic['driver']}"), ctx


def run_cell(cat: catalog.Catalog, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, rehearsal: Optional[Dict] = None,
             fault: Optional[str] = None, cache: str = CACHE,
             control: bool = False) -> Dict:
    """One run of ``workload``; returns the result's dict. ``rehearsal``
    overrides keys of the configuration and the mix (the CPU tests' tiny
    sizes); ``fault`` breaks the timed path on purpose (the tests of the
    check)."""
    import torch

    driver, ctx = cell_context(cat, workload, seed, seconds, trace, device,
                               rehearsal, fault, cache, control)
    res = driver.run(ctx)
    setup_s = res["setup_end"] - t_start
    run = SimpleNamespace(**res)
    metrics = {}
    if not trace:
        for m in cat.end_to_end(workload):
            v = setup_s if m["name"] == "setup_s" else res["e2e"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cat.per_layer(workload):
            v = cat.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    limits = cat.limits(workload)
    correct = checks.verdict(res["checks"], limits) and res["failed"] == 0
    dev = ctx.device
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": 1,
                      "memory_peak_bytes": int(res["memory_peak_bytes"])}}
    if trace:
        from nerfbench import tracing
        out["device"]["busy_s"] = float(res["trace"]["busy_s"])
        out["device"]["window_s"] = float(res["trace"]["wall_s"])
        out["breakdown"] = tracing.breakdown(res["trace"])
    out["build_s"] = program.build_seconds()
    out["checks"] = {k: {"value": float(res["checks"][k]), "limit": float(lim)}
                     for k, lim in limits.items()}
    if "control_checks" in res:
        out["control_checks"] = res["control_checks"]
    out["_setup_s"] = setup_s
    out["_numbers"] = res["checks"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run one benchmark cell once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    import torch

    cat = catalog.Catalog()
    chips = int(cat.workload(a.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"nerfbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run_cell(cat, a.workload, a.seed, a.seconds, bool(a.trace),
                   "cuda:0", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"nerfbench: modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    out.pop("_setup_s", None)
    numbers = out.pop("_numbers", None)
    print(f"numbers (compared or not): {json.dumps(numbers)}", file=sys.stderr)
    from nerfbench.counts import power_limit
    print(f"card: {power_limit()} (rooflines and mfu against the 700 W "
          "peaks)", file=sys.stderr)
    print(f"setup: {out['build_s']!r} s of setup_s built the port's kernels "
          "with nvcc", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
