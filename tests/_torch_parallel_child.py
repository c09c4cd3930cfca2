"""One rank of the port's multi-process CPU tests (tests/test_torch_parallel.py):
joins a Gloo process group through a file rendezvous, runs the job's cases
on its mesh and saves what each case produced. Imports no jax.

Not collected by pytest (no test_ prefix). Invoked as:
    python tests/_torch_parallel_child.py JOB RANK WORLD RENDEZVOUS OUT
"""

import sys
from datetime import timedelta

import torch
import torch.distributed as dist

from indoor_nerf_tpu_torch.bridge import (
    params_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from indoor_nerf_tpu_torch.parallel.shard import (
    gather_state,
    level_rows,
    make_mesh,
    make_sharded_train_step,
    shard_state,
)
from indoor_nerf_tpu_torch.parallel.sp import make_sharded_image_renderer


def _local_batch(batch, mesh):
    """This data rank's share of a global batch (the rays, and the patch
    rays, in equal contiguous shares)."""
    d, D = mesh.index("data"), mesh.size("data")
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // D
        out[k] = torch.as_tensor(v[d * n:(d + 1) * n])
    return out


def run_steps(case, mesh):
    state = shard_state(state_from_numpy(case["state"], "cpu"), mesh)
    step = make_sharded_train_step(case["cfg"], mesh)
    metrics = []
    for batch, draws in zip(case["batches"], case["draws"]):
        state, m = step(state, _local_batch(batch, mesh), draws=draws,
                        prior_weights=case.get("prior_weights"))
        metrics.append({k: (v if isinstance(v, float) else v.numpy())
                        for k, v in m.items()})
    return {"metrics": metrics, "local": state_to_numpy(state),
            "full": state_to_numpy(gather_state(state, mesh))}


def run_render(case, mesh):
    params = params_from_numpy({"params": case["params"]}, "cpu")["params"]
    model_axis = None
    if case.get("model_sharded"):
        model_axis = "model"
        t = params["table"]
        params["table"] = t[level_rows(mesh, t.shape[0])].clone()
    occ = None
    if case.get("occ") is not None:
        occ = {"density": torch.as_tensor(case["occ"])}
    H, W = case["hw"]
    render = make_sharded_image_renderer(case["cfg"], H, W, mesh,
                                         tile_rays=case["tile_rays"],
                                         model_axis=model_axis)
    out = render(params, case["c2w"], case["K"], case["near"], case["far"],
                 occ_state=occ)
    return {k: v.numpy() for k, v in out.items()}


RUN = {"steps": run_steps, "render": run_render}


def main(job_path, rank, world, rdv, out_path):
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh(tuple(job["axes"]), tuple(job["sizes"]))
        results = {c["name"]: RUN[c["kind"]](c, mesh) for c in job["cases"]}
        results["coords"] = mesh.coords
        torch.save(results, out_path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
