"""A training step never waits for the card: it builds no tensor from host
data and reads no tensor on the host once its constants are made
(``ops/constants.py``). On the CPU the step runs with every such call made
to raise (a proxy: on the card each would be a copy or a read that waits
for the queued work); on the card (marker ``cuda``) under
``torch.cuda.set_sync_debug_mode("error")``. This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_host_sync.py
"""

import pytest
import torch

from indoor_nerf_tpu_torch.ops.constants import device_constant
from indoor_nerf_tpu_torch.render.renderer import render_image
from indoor_nerf_tpu_torch.train.config import parse_args
from indoor_nerf_tpu_torch.train.step import init_train_state, train_step
from indoor_nerf_tpu_torch.train.trainer import one_batch

# The flagship at test size, with the priors active from step 0, pixel
# coordinates in the batch (--no_batching) and every extension of the step.
FLAGS = ["--flagship", "--dataset_type", "synthetic", "--use_viewdirs",
         "--white_bkgd", "--n_levels", "4", "--finest_res", "32",
         "--log2_hashmap_size", "12", "--occ_resolution", "16",
         "--occ_candidates", "32", "--occ_samples", "8", "--N_rand", "64",
         "--no_batching", "--precrop_iters", "0", "--use_structural_priors",
         "--predict_normals", "--structural_loss_start_iter", "0",
         "--distortion_loss_weight", "0.01", "--table_decay_weight", "0.01",
         "--ema_decay", "0.9", "--freq_anneal_iters", "8",
         "--view_anneal_iters", "8"]
HASH = ["--dataset_type", "synthetic", "--use_viewdirs", "--white_bkgd",
        "--n_levels", "4", "--finest_res", "32", "--log2_hashmap_size", "12",
        "--N_samples", "8", "--N_importance", "8", "--raw_noise_std", "1",
        "--N_rand", "64", "--use_structural_priors", "--predict_normals",
        "--structural_loss_start_iter", "0"]


def _warm(flags, device):
    """(cfg, batch, state, generator) after two steps: caches made."""
    torch.set_num_threads(1)
    cfg, batch = one_batch(parse_args(flags + ["--device", device.type]), device)
    state = init_train_state(torch.Generator(device=device).manual_seed(0),
                             cfg, device)
    gen = torch.Generator(device=device).manual_seed(1)
    for _ in range(2):
        state, _ = train_step(state, batch, cfg, gen)
    return cfg, batch, state, gen


def _raise(*args, **kwargs):
    raise AssertionError("a tensor made from host data, or read on the host, "
                         "inside the step")


@pytest.mark.parametrize("flags", [FLAGS, HASH], ids=["flagship", "hash_fine"])
def test_a_warm_step_builds_and_reads_no_host_tensor(flags, monkeypatch):
    cfg, batch, state, gen = _warm(flags, torch.device("cpu"))
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, _raise)
    for name in ("item", "tolist", "__float__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, _raise)
    state, metrics = train_step(state, batch, cfg, gen)
    assert "structural_manhattan" in metrics and state["step"] == 3


def test_constants_are_shared_and_made_outside_inference_mode():
    """A constant made first inside a render (inference mode) is an
    ordinary tensor, which a later step's backward can save."""
    with torch.inference_mode():
        a = device_constant((0.25, -1.5), torch.float32, "cpu")
    assert not a.is_inference()
    assert device_constant([0.25, -1.5], torch.float32, "cpu") is a
    x = torch.ones(2, requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(x / a), x)
    assert torch.equal(g, 1.0 / a)


def test_a_step_after_a_render_on_the_same_constants():
    """The order that broke: a test-mode render makes the constants (the
    grouped encode's level ids among them), then a step saves them for its
    backward."""
    from indoor_nerf_tpu_torch.data.load import load_dataset

    args = parse_args(FLAGS + ["--device", "cpu", "--ray_groups", "2,2,1,1"])
    cfg, batch = one_batch(args, torch.device("cpu"))
    scene = load_dataset(args)
    state = init_train_state(torch.Generator().manual_seed(0), cfg)
    render_image(state["params"], 4, 4, scene.K, scene.poses[0], scene.near,
                 scene.far, cfg.render, occ_state=state["occ"])
    state, metrics = train_step(state, batch, cfg, torch.Generator().manual_seed(1))
    assert torch.isfinite(metrics["loss"])


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [FLAGS, HASH], ids=["flagship", "hash_fine"])
def test_a_warm_step_does_not_synchronise_the_card(flags):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, batch, state, gen = _warm(flags, torch.device("cuda:0"))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        train_step(state, batch, cfg, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_cumprod_backward_is_torchs_no_zero_case():
    """The transmittance's cumprod: torch's own forward, and bit for bit
    the backward torch takes when no factor is zero, without its check."""
    from indoor_nerf_tpu_torch.ops.volume import _NonzeroCumprod

    g = torch.Generator().manual_seed(0)
    x = (torch.rand((64, 33), generator=g) * 0.9 + 0.05).requires_grad_(True)
    cot = torch.randn((64, 33), generator=g)
    out = _NonzeroCumprod.apply(x)
    assert torch.equal(out, torch.cumprod(x, dim=-1))
    (got,) = torch.autograd.grad(out, x, cot)
    (want,) = torch.autograd.grad(torch.cumprod(x, dim=-1), x, cot)
    assert torch.equal(got, want)
