"""The baked renderer on the card (marker ``cuda``; skipped without one).

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_baked_cuda.py

This file imports no jax, so it runs where the card is. The bake's vertex
sweep goes through the ``tent_contract`` kernel and is held against the
same bake with the kernel's plain version; a baked render on the card is
held against the same snapshot rendered on the CPU.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from indoor_nerf_tpu_torch.models.field import FieldConfig, init_field_params
from indoor_nerf_tpu_torch.ops import blockhash
from indoor_nerf_tpu_torch.ops import tent_contract as tc
from indoor_nerf_tpu_torch.ops.blockhash import BlockHashConfig
from indoor_nerf_tpu_torch.render import baked as tb

BBOX = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _field(device, gather_dtype):
    """A flagship-shaped field (side 4, F 4) at a small table, O(1) entries."""
    fc = FieldConfig(block_grid=BlockHashConfig(
        bbox_min=BBOX[0], bbox_max=BBOX[1], n_levels=4, n_features_per_level=4,
        log2_rows=8, base_resolution=8, finest_resolution=64, block_size=3,
        gather_dtype=gather_dtype, scatter_dtype=gather_dtype))
    g = torch.Generator(device=device).manual_seed(0)
    params = init_field_params(g, fc, device)
    params["table"] = torch.randn(params["table"].shape, generator=g,
                                  device=device)
    return fc, params


def _cameras():
    c2w = np.concatenate([np.eye(3, dtype=np.float32),
                          np.array([[0.0], [0.0], [4.0]], np.float32)], axis=1)
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    return {"poses": c2w[None], "K": K, "H": 32, "W": 32, "near": 2.0,
            "far": 6.0}, c2w, K


@pytest.mark.cuda
@pytest.mark.parametrize("gather_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
def test_cuda_bake_sweep_matches_plain(gather_dtype, table_dtype):
    """The sweep launches ``tent_contract`` once per chunk (and per chunk of
    the visibility rays); with the plain version in its place the tables
    agree to f32 rounding before their bf16 / int8 rounding: an entry may
    fall to the neighbouring value, rarely."""
    _need_card()
    fc, params = _field(torch.device("cuda:0"), gather_dtype)
    cams, _, _ = _cameras()
    kw = dict(resolution=32, table_dtype=table_dtype, blocks_per_chunk=64,
              train_cameras=cams)
    tc.reset_launch_count()
    got = tb.bake_field(params, fc, **kw)
    launches = tc.launch_count()
    assert launches >= -(-33 ** 3 // (64 * 128)) + 1
    with mock.patch.object(blockhash, "tent_contract", tc.tent_contract_plain):
        want = tb.bake_field(params, fc, **kw)
    assert tc.launch_count() == launches  # the plain bake launched nothing
    for key in ("sigma_table", "voxel_geo"):
        g, w = got[key].float(), want[key].float()
        # One level, or one bfloat16 step; entries near 0 are sums that
        # cancel: 1e-5 of the largest entry that is not a culled -1e4.
        step = (1.0 if got[key].dtype == torch.int8 else
                2.0 ** -7 * w.abs() + 1e-5 * float(w[w > -1e3].abs().max()))
        assert bool(((g - w).abs() <= step).all()), key
        assert float(((g - w).abs() > 0).float().mean()) < 0.01, key
    torch.testing.assert_close(got["block_max"], want["block_max"],
                               rtol=2.0 ** -6, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("guided", [0, 4])
@pytest.mark.parametrize("table_dtype", ["bfloat16", "float32", "int8"])
def test_cuda_baked_render_matches_cpu(table_dtype, guided):
    """One snapshot rendered on the card and on the CPU. Float tables take
    pass 1 through ``tent_contract`` on the card (f32 tent weights) and
    through the plain form on the CPU (weights rounded to the rows' dtype:
    2^-9 relative per bf16 weight), so bf16 is held at 2e-2; f32 and int8
    tables differ by summation order alone: 1e-4. Guided renders take their
    interval from sample depths of the coarse pass, so a bound may move by
    a coarse step at single pixels: held on the mean."""
    _need_card()
    fc, params = _field(torch.device("cuda:0"), "bfloat16")
    _, c2w, K = _cameras()
    baked = tb.bake_field(params, fc, resolution=32, table_dtype=table_dtype,
                          blocks_per_chunk=64)
    on_cpu = {k: (v.cpu() if torch.is_tensor(v) else v)
              for k, v in baked.items() if k != "color_net"}
    on_cpu["color_net"] = [{k: v.cpu() for k, v in l.items()}
                           for l in baked["color_net"]]
    kw = dict(n_samples=16 if guided else 64, guided=guided, n_coarse=32)
    tc.reset_launch_count()
    got = tb.make_baked_image_renderer(baked, 48, 48, **kw)(c2w, K, 2.0, 6.0)
    assert (tc.launch_count() > 0) == (table_dtype != "int8")
    want = tb.make_baked_image_renderer(on_cpu, 48, 48, **kw)(c2w, K, 2.0, 6.0)
    tol = 2e-2 if table_dtype == "bfloat16" else 1e-4
    assert float(want["acc_map"].max()) > 0.5
    for key in ("rgb_map", "acc_map"):
        diff = (got[key].cpu() - want[key]).abs()
        if guided:
            assert float(diff.mean()) <= tol, key
        else:
            assert float(diff.max()) <= tol, key


@pytest.mark.cuda
def test_cuda_baked_render_rays_never_waits_for_the_card():
    """A tile of the unguided baked render launches its work and returns
    without one host-card synchronisation (a synchronising call raises under
    ``set_sync_debug_mode("error")``), so the host stays ahead of the card
    and a request's time is the card's. The first tile makes the render's
    constants; later tiles reuse them."""
    _need_card()
    dev = torch.device("cuda:0")
    fc, params = _field(dev, "bfloat16")
    baked = tb.bake_field(params, fc, resolution=32, table_dtype="bfloat16",
                          blocks_per_chunk=64)
    g = torch.Generator(device=dev).manual_seed(1)
    rays_o = torch.rand(4096, 3, generator=g, device=dev) - 0.5
    rays_d = torch.randn(4096, 3, generator=g, device=dev)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    with torch.inference_mode():
        want = tb.baked_render_rays(baked, rays_o, rays_d, viewdirs, 0.05, 6.0)
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = tb.baked_render_rays(baked, rays_o, rays_d, viewdirs, 0.05,
                                       6.0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
