"""Mip-NeRF 360's step on the card against the port's own CPU step and the
benchmark's reference (marker ``cuda``; skipped without a card). This file
imports no jax, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_mipnerf360_cuda.py

At the published widths (the NeRF MLP 8 x 1024 with its 256 bottleneck
and 128 view layer, the proposal MLP 4 x 256, 64 + 64 + 32 intervals) on
256 rays of the room from the same seeded state at step 6000, two steps.
Tolerances: the loss 1e-4 relative and each leaf's RAdam first moment (the
clipped gradient) 5e-3 relative in norm, the CPU's and the card's float32
GEMMs summing 1,024 terms a product in other orders through 8 layers
(first reading 2.2e-5 on the loss), and the resampled intervals following
the weights; the first step's loss against the reference on the card, on
the same GEMMs, to 1e-5."""

import numpy as np
import pytest
import torch

from nerfbench.reference import mipnerf360 as ref
from indoor_nerf_tpu_torch.data.load import load_dataset
from indoor_nerf_tpu_torch.data.scene_files import (
    make_room_blender_scene,
    write_blender_scene,
)
from indoor_nerf_tpu_torch.render import proposal
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.train.optim import named_leaves
from indoor_nerf_tpu_torch.train.step import draw_step, init_train_state, train_step
from indoor_nerf_tpu_torch.train.trainer import build_train_config, make_sampler

pytestmark = pytest.mark.cuda
N_RAYS = 256


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fused RAdam kernel has no CPU mode)")


def _run(cfg, device, batches, params):
    state = init_train_state(torch.Generator(device=device).manual_seed(3),
                             cfg, device)
    with torch.no_grad():
        for k, t in named_leaves(state["params"]).items():
            t.copy_(params[k])
    state["step"] = state["opt"]["step"] = 6000
    gen = torch.Generator().manual_seed(11)
    out = []
    for b in batches:
        d = draw_step(gen, cfg, state["step"], b["rays_o"].shape[0])
        d = {k: v.to(device) for k, v in d.items()}
        state, m = train_step(state, {k: v.to(device) for k, v in b.items()},
                              cfg, draws=d)
        out.append((float(m["loss"]), d,
                    {k: v.detach().cpu().clone()
                     for k, v in state["opt"]["mu"].items()}))
    return out


def test_mipnerf360_step_card_against_cpu_and_reference(tmp_path):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    write_blender_scene(str(tmp_path), make_room_blender_scene(6, 40, 40))
    args = parse_args(["--mipnerf360", "--dataset_type", "blender",
                       "--datadir", str(tmp_path), "--device", "cpu",
                       "--N_rand", str(N_RAYS)])
    scene = load_dataset(args)
    cfg = build_train_config(args, scene)
    assert cfg.render.chain.config.netwidth == 1024
    sample, _ = make_sampler(args, scene, cfg, 0)
    batches = [{k: torch.from_numpy(v) for k, v in sample(i).items()}
               for i in (1, 2)]
    spec = ref.make_spec({"N_rand": N_RAYS}, float(scene.hwf[2]))
    params = ref.make_params(spec, 2**31 + 7, "cpu")
    proposal.reset_counts()
    cpu = _run(cfg, "cpu", batches, params)
    card = _run(cfg, "cuda", batches, {k: v.cuda() for k, v in params.items()})
    assert proposal.sample_counts()["field"] == 2 * 2 * N_RAYS * 32
    for (lc, _, mc), (lg, _, mg) in zip(cpu, card):
        gaps = {k: abs(float(mc[k].norm()) - float(mg[k].norm()))
                / max(float(mc[k].norm()), 1e-30) for k in mc}
        print(f"loss gap {abs(lc - lg) / abs(lc):.3g}, worst moment gap "
              f"{max(gaps.values()):.3g} ({max(gaps, key=gaps.get)})")
        assert abs(lc - lg) <= 1e-4 * abs(lc)
        for k, g in gaps.items():
            assert g <= 5e-3, k
    dev = torch.device("cuda")
    r = ref.run_steps({k: v.to(dev) for k, v in params.items()},
                      [{k: v.to(dev) for k, v in batches[0].items()}],
                      [card[0][1]], spec, 6000)
    assert abs(r["losses"][0] - card[0][0]) <= 1e-5 * r["losses"][0]
    assert np.isfinite(r["losses"][0])
