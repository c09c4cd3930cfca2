"""Nerfacto's step on the card against the port's own CPU step (marker
``cuda``; skipped without a card). This file imports no jax, so it runs
where the card is:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_nerfacto_cuda.py

At the published widths (16 x 2 levels at 2^19 rows, proposal fields 5 x
2 at 2^17, 256 + 96 + 48 samples) on 256 rays of the room, from the same
seeded state, an update step (6 steps after the last) then a step that
leaves the proposals alone. Tolerances: the loss 1e-5 relative and each
leaf's RAdam first moment 5e-3 relative in norm (f32 sums in other orders
and the hash grids' atomic ``index_add_`` on the card, as
``tests/test_torch_parity_cuda.py``); the proposal leaves untouched on the
second step on both devices."""

import numpy as np
import pytest
import torch

from indoor_nerf_tpu_torch.data.load import load_dataset
from indoor_nerf_tpu_torch.data.scene_files import (
    make_room_blender_scene,
    write_blender_scene,
)
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.train.optim import named_leaves
from indoor_nerf_tpu_torch.train.step import draw_step, init_train_state, train_step
from indoor_nerf_tpu_torch.train.trainer import build_train_config, make_sampler

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fused RAdam kernel has no CPU mode)")


def _run(args, scene, cfg, device, batches):
    state = init_train_state(torch.Generator().manual_seed(3), cfg)
    if device != "cpu":
        cuda = init_train_state(torch.Generator(device=device).manual_seed(3),
                                cfg, device)
        with torch.no_grad():
            for k, t in named_leaves(cuda["params"]).items():
                t.copy_(named_leaves(state["params"])[k])
        state = cuda
    state["step"] = state["opt"]["step"] = 6000
    state["proposal_since"] = 6
    gen = torch.Generator().manual_seed(11)
    out = []
    for b in batches:
        d = draw_step(gen, cfg, state["step"], b["rays_o"].shape[0])
        d = {k: v.to(device) for k, v in d.items()}
        state, m = train_step(state, {k: v.to(device) for k, v in b.items()},
                              cfg, draws=d)
        out.append((float(m["loss"]), bool(m["proposal_update"]),
                    {k: v.detach().cpu().clone()
                     for k, v in state["opt"]["mu"].items()},
                    {k: v.detach().cpu().clone()
                     for k, v in named_leaves(state["params"]).items()}))
    return out


def test_nerfacto_step_card_against_cpu(tmp_path):
    _need_card()
    d = str(tmp_path / "room")
    write_blender_scene(d, make_room_blender_scene(8, 64, 64))
    args = parse_args(["--nerfacto", "--dataset_type", "blender", "--datadir",
                       d, "--no_batching", "--N_rand", "256", "--device",
                       "cpu"])
    scene = load_dataset(args)
    cfg = build_train_config(args, scene)
    sample, _ = make_sampler(args, scene, cfg, 5)
    batches = [{k: torch.from_numpy(v) for k, v in sample(i).items()}
               for i in (6001, 6002)]
    cpu = _run(args, scene, cfg, "cpu", batches)
    card = _run(args, scene, cfg, "cuda", batches)
    for (lc, uc, muc, pc), (lg, ug, mug, pg) in zip(cpu, card):
        assert uc == ug
        assert abs(lg - lc) <= 1e-5 * abs(lc)
        for k in muc:
            want = float(muc[k].norm())
            assert abs(float(mug[k].norm()) - want) <= 5e-3 * max(want, 1e-12), k
    assert [u for _, u, _, _ in card] == [True, False]
    # The second step leaves the proposal fields as the first left them.
    for k in card[0][3]:
        if k.startswith("proposal_"):
            assert torch.equal(card[0][3][k], card[1][3][k]), k
            assert torch.equal(cpu[0][3][k], cpu[1][3][k]), k
    assert np.isfinite(card[1][0])
