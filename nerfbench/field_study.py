"""The served field of ``room_blockhash.serve`` against a trained one.

    python3 -m nerfbench.field_study --seed <n> [--train_steps 3000] \\
        [--seconds 15] [--rounds 2]

The serving cell serves a field made from the seed (the weights, and their
own density as the occupancy grid), because the reference may take no
weights that the program has made. This study asks whether that field
loads the renderer as a trained room does. It trains the flagship
configuration with the port's own step for ``--train_steps`` steps on the
benchmark's room (the ``train`` mix's loop from step 1, priors moved out),
then serves the seeded field and the trained one in turns, ``--rounds``
times each, under the ``serve`` mix with its traced stretch, in this one
process. One JSON line each: the latency quantiles, the idle share, the
encode's roofline share, the operations a request, the shares of grid
cells whose density passes 0.01, 1 and 100, and the numbers that decide ``correct`` (the reference renders
the trained field too). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from nerfbench import catalog, program, run
from nerfbench.drivers import train as train_driver
from nerfbench.drivers.serve import seeded_field
from nerfbench.reference.spec import blender_bbox, make_spec

CELL = "room_blockhash.serve"


def trained_field(cat: catalog.Catalog, seed: int, steps: int, dev):
    """(weights, occupancy grid) after ``steps`` of the port's training
    from its own initial state, the steps' seconds and the last step's
    training PSNR."""
    _, ctx = run.cell_context(cat, "room_blockhash.train", seed, 0.0, False,
                              dev)
    args = dict(ctx.config["args"])
    args.update(ctx.traffic.get("flags", {}))
    tr = program.Training(program.cli_flags(
        args, {"datadir": ctx.scene_dir, "device": str(dev)}), dev, seed)
    loop = train_driver._Loop(tr, torch.Generator(device=dev).manual_seed(seed + 1))
    t0 = time.perf_counter()
    for i in range(1, steps):
        loop.step(i)
    psnr = float(loop.step(steps, keep=True)[2]["psnr"])
    loop.finish()
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    params = {k: v.detach().clone() for k, v in tr.leaves().items()}
    density = tr.state["occ"]["density"].detach().reshape(-1).clone()
    tr.free()
    return params, density, seconds, psnr


def serve_once(cat: catalog.Catalog, seed: int, seconds: float, field) -> dict:
    driver, ctx = run.cell_context(cat, CELL, seed, seconds, True, "cuda:0")
    if field is not None:
        ctx.field = field
    torch.cuda.reset_peak_memory_stats()
    res = driver.run(ctx)
    r = argparse.Namespace(**res)
    per_layer = {m["name"]: cat.reader(m["name"])(r) for m in cat.per_layer(CELL)}
    return {"e2e": res["e2e"], "attempted": res["attempted"],
            "per_layer": per_layer, "checks": res["checks"],
            "busy_s": res["trace"]["busy_s"], "window_s": res["trace"]["wall_s"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--train_steps", type=int, default=3000)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("field_study: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    cat = catalog.Catalog()
    params, density, train_s, psnr = trained_field(cat, a.seed, a.train_steps,
                                                   dev)
    print(json.dumps({"trained_steps": a.train_steps, "train_s": train_s,
                      "train_psnr": psnr}), flush=True)
    _, ctx = run.cell_context(cat, CELL, a.seed, 0.0, False, dev)
    spec = make_spec(ctx.config["args"], blender_bbox(ctx.scene_dir)[:2])
    _, seeded_density = seeded_field(spec, a.seed, dev,
                                     float(ctx.traffic["table_scale"]))
    occupied = {name: [float((d > v).float().mean()) for v in (0.01, 1.0, 100.0)]
                for name, d in (("seeded", seeded_density), ("trained", density))}
    del seeded_density
    for r in range(a.rounds):
        for name, field in (("seeded", None),
                            ("trained", lambda: (params, density))):
            out = serve_once(cat, a.seed, a.seconds, field)
            out.update(field=name, round=r, occupied_share=occupied[name])
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
