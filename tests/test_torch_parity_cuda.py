"""The parity path on the card against the port's own CPU path (marker
``cuda``; skipped without a card). This file imports no jax, so it runs
where the card is:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_parity_cuda.py

Tolerances: the hash grid's corner rows and keep mask bit for bit (the
same f32 op order on both: IEEE division and floor); its trilinear weights
1e-6; the encode and its table gradient 1e-5 of their largest entry (f32
sums in other orders, atomics on the card); one parity step's loss 1e-5
relative and its RAdam moments 5e-3 relative in norm (forwards that differ
in f32 order, as chip_smoke.py's FORWARD_NORM_TOL)."""

import numpy as np
import pytest
import torch

from indoor_nerf_tpu_torch.ops import encoding as te

pytestmark = pytest.mark.cuda

GRID = te.HashGridConfig(bbox_min=(-1.5, -1.5, -1.5), bbox_max=(1.5, 1.5, 1.5))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the card path has no CPU mode)")


def _points(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, 3), generator=g) * 3.6 - 1.8
    # Points on voxel faces of the finest level (min + i * size).
    size = torch.tensor(3.0, dtype=torch.float32) / 512.0
    i = torch.randint(0, 512, (n, 3), generator=g).float()
    return torch.cat([x, -1.5 + i * size])


def test_hash_grid_indices_card_equal_cpu():
    _need_card()
    x = _points(20000)
    cf, cw, ck = te.hash_grid_indices(x, GRID)
    gf, gw, gk = te.hash_grid_indices(x.cuda(), GRID)
    assert torch.equal(gf.cpu(), cf) and torch.equal(gk.cpu(), ck)
    assert float((gw.cpu() - cw).abs().max()) <= 1e-6


def test_hash_encode_and_gradient_card_against_cpu():
    _need_card()
    x = _points(20000, seed=1)
    g = torch.Generator().manual_seed(2)
    table = torch.randn((GRID.n_levels * GRID.table_size, 2), generator=g)
    cot = torch.randn((x.shape[0], GRID.out_dim), generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        t = table.to(dev).requires_grad_(True)
        feats, _ = te.hash_encode(x.to(dev), t, GRID)
        (grad,) = torch.autograd.grad((feats * cot.to(dev)).sum(), t)
        out[dev] = (feats.detach().cpu(), grad.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("extra", [[], ["--i_embed", "0", "--i_embed_views",
                                        "0"]], ids=["hash", "pe"])
def test_parity_step_card_against_cpu(extra):
    """One step of configs/lego.txt's model (the hash grid, or PE with the
    classic NeRF) at test-sized sample counts, on the same state, batch
    and draws."""
    _need_card()
    from indoor_nerf_tpu_torch.bridge import state_from_numpy, state_to_numpy
    from indoor_nerf_tpu_torch.train.config import parse_args
    from indoor_nerf_tpu_torch.train.step import draw_step, init_train_state, train_step
    from indoor_nerf_tpu_torch.train.trainer import one_batch

    args = parse_args(["--dataset_type", "synthetic", "--use_viewdirs",
                       "--white_bkgd", "--N_samples", "16", "--N_importance",
                       "16", "--N_rand", "256", "--raw_noise_std", "1",
                       "--device", "cpu"] + extra)
    cfg, batch = one_batch(args, torch.device("cpu"))
    tree = state_to_numpy(init_train_state(torch.Generator().manual_seed(0), cfg))
    draws = draw_step(torch.Generator().manual_seed(1), cfg, 0, 256)
    res = {}
    for dev in ("cpu", "cuda"):
        state = state_from_numpy(tree, dev)
        state, m = train_step(state, {k: v.to(dev) for k, v in batch.items()},
                              cfg, draws={k: v.to(dev) for k, v in draws.items()})
        res[dev] = (float(m["loss"]), state_to_numpy(state))
    assert abs(res["cuda"][0] / res["cpu"][0] - 1) <= 1e-5
    for key in ("mu", "nu"):
        for name, want in res["cpu"][1]["opt"][key].items():
            got = res["cuda"][1]["opt"][key][name]
            got, want = (np.concatenate([np.ravel(v) for v in
                                         _leaves(t)]) for t in (got, want))
            assert np.linalg.norm(got - want) <= 5e-3 * np.linalg.norm(want)


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, list):
        return [v for t in tree for v in _leaves(t)]
    return [tree]
