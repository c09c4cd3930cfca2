"""The occupancy sampler's dispatch and the kernel's refusals on the CPU
(ops/occupancy.py): a CPU tensor takes the plain chain, bit for bit, and
counts nothing; the refusals the kernel's wrapper makes before any launch
(the caps, dtype, shape, contiguity, device). The kernel itself runs only
on the card (tests/test_torch_occ_sample_cuda.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from indoor_nerf_tpu_torch.cuda_build import launch_counts, reset_counts
from indoor_nerf_tpu_torch.ops import occupancy
from indoor_nerf_tpu_torch.ops.occupancy import (
    MAX_CANDIDATES,
    MAX_SAMPLES,
    OccupancyConfig,
    occ_sample,
    occupancy_z_vals,
    occupancy_z_vals_plain,
    torch_scan_chunk,
    torch_sum_width,
)
from indoor_nerf_tpu_torch.ops.sampling import draw_pdf_u, linspace01
from nerfbench.reference import render as reference
from nerfbench.reference.spec import make_spec

BOX = ((-1.0, -0.8, -0.5), (1.2, 0.9, 1.5))


def _config(weighting="transmittance", m=32, resolution=8):
    return OccupancyConfig(bbox_min=BOX[0], bbox_max=BOX[1],
                           resolution=resolution, n_candidates=m,
                           weighting=weighting)


def _inputs(config, n=48, samples=8, seed=0, draws=True):
    g = torch.Generator().manual_seed(seed)
    rays_o = torch.rand((n, 3), generator=g) * 0.4 - 0.2
    rays_d = torch.randn((n, 3), generator=g)
    near, far = torch.full((n, 1), 0.05), torch.full((n, 1), 2.5)
    density = torch.rand(config.n_cells, generator=g) * 4
    density[density < 2.0] = 0.0  # empty cells, so weights vary
    t_rand = torch.rand((n, config.n_candidates), generator=g) if draws else None
    u = draw_pdf_u(g, n, samples) if draws else None
    return rays_o, rays_d, near, far, {"density": density}, t_rand, u


@pytest.mark.parametrize("weighting", ["transmittance", "density"])
@pytest.mark.parametrize("step", [None, 3, 1000])
@pytest.mark.parametrize("draws", [False, True])
def test_cpu_takes_the_plain_chain_and_counts_nothing(weighting, step, draws):
    config = _config(weighting)
    ro, rd, near, far, occ, t_rand, u = _inputs(config, draws=draws)
    reset_counts()
    got = occupancy_z_vals(ro, rd, near, far, occ, config, 8, step,
                           t_rand=t_rand, u=u)
    assert not any(launch_counts().values())
    want = occupancy_z_vals_plain(ro, rd, near, far, occ, config, 8, step,
                                  t_rand=t_rand, u=u)
    assert torch.equal(got, want)
    assert got.shape == (48, 8)
    assert bool(torch.all(got[:, 1:] >= got[:, :-1]))


@pytest.mark.parametrize("weighting", ["transmittance", "density"])
@pytest.mark.parametrize("draws", [False, True])
def test_plain_chain_is_the_reference_sampler_bit_for_bit(weighting, draws):
    """The plain chain is the benchmark reference's sampler (independent
    plain PyTorch) to the bit, as it was before the kernel."""
    config = _config(weighting)
    spec = make_spec({"i_embed": 3, "use_occupancy": True,
                      "occ_resolution": 8, "occ_candidates": 32,
                      "occ_samples": 8, "occ_weighting": weighting}, BOX)
    ro, rd, near, far, occ, t_rand, u = _inputs(config, seed=3, draws=draws)
    for step in (None, 10, 300):
        warm = step is not None and step < config.warmup_steps
        want = reference.occupancy_z(ro, rd, near, far, occ["density"], spec,
                                     warm, t_rand, u)
        got = occupancy_z_vals(ro, rd, near, far, occ, config, 8, step,
                               t_rand=t_rand, u=u)
        assert torch.equal(got, want)


def test_kernel_scalars_are_the_plain_chains_numbers():
    """The float32 scalars the kernel takes are the ones the plain chain's
    tensor ops meet."""
    config = _config("transmittance", m=128)
    c = occupancy._kernel_scalars(config, 32)
    bmin = torch.tensor(BOX[0], dtype=torch.float32)
    ext = torch.tensor(BOX[1], dtype=torch.float32) - bmin
    assert np.array_equal(c[:3], bmin.numpy())
    assert np.array_equal(c[3:6], ext.numpy())
    assert np.float32(126) * c[6] == linspace01(128)[126].item()
    assert np.float32(30) * c[7] == linspace01(32)[30].item()
    assert c[8] == np.float32(config.floor / 127)
    assert c[9] == np.float32(0.15) and c[10] == np.float32(0.85)
    d = occupancy._kernel_scalars(_config("density", m=128), 1)
    assert d[7] == 0.0 and d[8] == np.float32(config.floor)


# torch's orders as read on an H100 (torch 2.11, CUDA 12.8): emulations of
# torch.sum and torch.cumsum at these widths and chunks equal its results
# bit for bit on every row of [rows, n] float32 tensors.
SUM_WIDTHS = {(7, 1024): 4, (31, 1024): 16, (32, 1024): 32, (63, 1024): 32,
              (127, 1024): 32, (127, 524288): 32, (63, 8): 32, (64, 8): 64,
              (127, 8): 64, (64, 16): 32, (127, 16): 32}
SCAN_CHUNKS = {(7, 8): 32, (31, 8): 64, (63, 8): 128, (63, 16): 64,
               (126, 16): 128, (126, 1024): 32, (127, 1024): 32,
               (126, 65536): 32, (7, 65536): 1024, (126, 65537): 1024,
               (127, 115712): 1024, (126, 524288): 1024}


@pytest.mark.parametrize("n, rows", sorted(SUM_WIDTHS))
def test_sum_width_is_torchs(n, rows):
    assert torch_sum_width(n, rows) == SUM_WIDTHS[n, rows]


@pytest.mark.parametrize("n, rows", sorted(SCAN_CHUNKS))
def test_scan_chunk_is_torchs(n, rows):
    assert torch_scan_chunk(n, rows) == SCAN_CHUNKS[n, rows]


def test_kernel_orders_follow_the_weighting_and_the_rays():
    """The serving tile's scans are whole rows, a training batch's chunks
    of 32; the density weighting sums one entry fewer."""
    t = list(occupancy._kernel_orders(_config("transmittance", 128), 524288))
    assert t == [32, 32, 32, 32]  # widths 32; chunks of 1024 = 32 slots
    assert list(occupancy._kernel_orders(_config("transmittance", 128),
                                         1024)) == [32, 32, 1, 1]
    assert list(occupancy._kernel_orders(_config("density", 32), 1024)) == \
        [16, 16, 1, 1]
    assert list(occupancy._kernel_orders(_config("transmittance", 128),
                                         8)) == [64, 64, 4, 4]


def _refused(config, samples, **change):
    ro, rd, near, far, occ, t_rand, u = _inputs(config, samples=samples)
    args = dict(rays_o=ro, rays_d=rd, near=near, far=far,
                density=occ["density"], t_rand=t_rand, u=u)
    args.update(change)
    return lambda: occ_sample(config=config, n_samples=samples, warmup=False,
                              **args)


@pytest.mark.parametrize("case, kind, match", [
    ("candidates", ValueError, "2 to 128 candidates"),
    ("density_candidates", ValueError, "3 to 128 candidates"),
    ("samples", ValueError, "1 to 256 samples"),
    ("dtype", TypeError, "rays_d as torch.float32"),
    ("contiguity", ValueError, "rays_o contiguous"),
    ("draw_shape", ValueError, r"t_rand of shape \(48, 32\)"),
    ("near_shape", ValueError, r"near of shape \(48, 1\)"),
    ("grid_size", ValueError, r"density of shape \(512,\)"),
    ("weighting", ValueError, "no weighting 'cone'"),
    ("device", ValueError, "runs on a CUDA device"),
])
def test_refusals_before_any_launch(case, kind, match):
    """Each input the kernel cannot take raises before a launch, whatever
    the device; valid CPU inputs are refused too: the kernel has no CPU
    mode, and occupancy_z_vals never sends CPU tensors to it."""
    config, samples, change = _config(), 8, {}
    ro = _inputs(config)[0]
    if case == "candidates":
        config = _config(m=MAX_CANDIDATES + 1)
    elif case == "density_candidates":
        config = _config("density", m=2)
    elif case == "samples":
        samples = MAX_SAMPLES + 1
    elif case == "dtype":
        change = {"rays_d": _inputs(config)[1].double()}
    elif case == "contiguity":
        change = {"rays_o": torch.cat([ro, ro], 1)[:, ::2]}
    elif case == "draw_shape":
        change = {"t_rand": torch.rand((48, 31))}
    elif case == "near_shape":
        change = {"near": torch.full((48,), 0.05)}
    elif case == "grid_size":
        change = {"density": torch.ones(8 ** 3 + 1)}
    elif case == "weighting":
        config = dataclasses.replace(config, weighting="cone")
    reset_counts()
    with pytest.raises(kind, match=match):
        _refused(config, samples, **change)()
    assert not any(launch_counts().values())


def test_caps_cover_the_defaults():
    """The parser's defaults (128 candidates, 64 samples) and the flagship's
    32 samples are under the caps."""
    assert MAX_CANDIDATES >= 128 and MAX_SAMPLES >= 64
    assert OccupancyConfig(bbox_min=BOX[0], bbox_max=BOX[1]).n_candidates \
        <= MAX_CANDIDATES
