"""The seam of the port's CUDA kernels (indoor_nerf_tpu_torch/cuda_build.py)
on the CPU: the declared C signatures against each csrc/<name>.cu, read
without nvcc, and the one launch counter. The kernels themselves run only
on the card (the cuda-marked tests beside each op)."""

import contextlib
import re
import types

import pytest
import torch

from indoor_nerf_tpu_torch import cuda_build
from indoor_nerf_tpu_torch.cuda_build import (
    SIGNATURES,
    count,
    launch_counts,
    launch_on_stream,
    parse_signature,
    reset_counts,
)
from indoor_nerf_tpu_torch.models.mlp import init_nerf_small
from indoor_nerf_tpu_torch.models.mlp_fused import nerf_small_fused
from indoor_nerf_tpu_torch.ops.occupancy import OccupancyConfig, occupancy_z_vals
from indoor_nerf_tpu_torch.ops.group_scatter import group_scatter
from indoor_nerf_tpu_torch.ops.lane_gather import lane_select
from indoor_nerf_tpu_torch.ops.table_scatter import table_scatter
from indoor_nerf_tpu_torch.ops.tent_contract import (
    pack_rows,
    pack_rows_int8,
    tent_contract,
)
from indoor_nerf_tpu_torch.ops.tile_interp import tile_interp
from indoor_nerf_tpu_torch.train.optim import init_radam_state, radam_update

LIBRARIES = ("tent_contract", "table_scatter", "group_scatter", "tile_interp",
             "lane_gather", "fused_radam", "nerf_small_fused", "occ_sample")
# The C types of the extern "C" blocks, const dropped, as SIGNATURES' kinds.
C_KINDS = {"void*": "ptr", "int": "i32", "long long": "i64", "int*": "i32*",
           "unsigned int*": "u32*", "char*": "str"}
FUNCTION = re.compile(r"^(?P<ret>[A-Za-z_][\w ]*?\**)\s*\b(?P<name>\w+)"
                      r"\((?P<params>[^)]*)\)\s*\{", re.M)


def _kind(c_type: str) -> str:
    c_type = re.sub(r"\s*\*", "*", c_type.replace("const ", "")).strip()
    return C_KINDS[c_type]


def _extern_c(name: str) -> dict:
    """``{function: (argument kinds, return kind)}`` of the extern "C"
    block of ``csrc/<name>.cu``."""
    src = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
    block = re.search(r'extern "C" \{(.*?)\}  // extern "C"', src, re.S)
    assert block, f"csrc/{name}.cu has no extern \"C\" block"
    out = {}
    for m in FUNCTION.finditer(block.group(1)):
        params = [p.strip() for p in m.group("params").split(",") if p.strip()]
        args = tuple(_kind(re.sub(r"\s*\b\w+$", "", p)) for p in params)
        out[m.group("name")] = (args, _kind(m.group("ret")))
    return out


@pytest.mark.parametrize("name", LIBRARIES)
def test_signatures_match_the_c_source(name):
    """Every C function of the library is declared with its argument and
    return kinds, and nothing else is; the error string by convention."""
    defined = _extern_c(name)
    assert defined.pop(f"{name}_error_string") == (("i32",), "str")
    declared = {fn: parse_signature(sig) for fn, sig in SIGNATURES[name].items()}
    assert declared == defined


def test_every_library_has_signatures():
    assert set(SIGNATURES) == set(LIBRARIES) == {
        p.stem for p in cuda_build.CSRC_DIR.glob("*.cu")}


def test_plain_calls_count_nothing():
    """Each op's CPU call takes its plain version: no count moves."""
    g = torch.Generator().manual_seed(0)
    F, lpf, side, rows, M = 2, 64, 4, 8, 16
    master = torch.randn((rows, F * lpf), generator=g)
    flat_row = torch.randint(0, rows, (M,), generator=g, dtype=torch.int32)
    p = torch.rand((M, 3), generator=g) * (side - 1)
    reset_counts()
    tent_contract(pack_rows(master, F, torch.bfloat16), flat_row, p, side, F)
    pack_rows_int8(master, F, 2)
    table_scatter(torch.randn((M, F), generator=g), p, flat_row, rows, side,
                  lpf)
    Rn, S, L = 2, 4, 2
    group_scatter(torch.randn((Rn, S, L * F), generator=g),
                  torch.randint(0, rows, (Rn, S, L), generator=g,
                                dtype=torch.int32),
                  torch.rand((Rn, S, L, 3), generator=g) * (side - 1),
                  (2, 1), rows, side, lpf)
    tiles = torch.randn((M, 256), generator=g, requires_grad=True)
    tile_interp(tiles, torch.rand((M, 3), generator=g) * 4).sum().backward()
    values = torch.randn((M, 128), generator=g, requires_grad=True)
    idx = torch.randint(0, 128, (M, 8), generator=g, dtype=torch.int32)
    lane_select(values, idx).sum().backward()
    net = init_nerf_small(g, predict_normals=True)
    with torch.no_grad():
        nerf_small_fused(net, torch.randn((M, 32), generator=g),
                         torch.randn((M // 4, 16), generator=g), 4,
                         torch.ones(M, dtype=torch.bool))
    occ = OccupancyConfig(bbox_min=(-1.0,) * 3, bbox_max=(1.0,) * 3,
                          resolution=4, n_candidates=16,
                          weighting="transmittance")
    occupancy_z_vals(torch.zeros((M, 3)), torch.randn((M, 3), generator=g),
                     torch.full((M, 1), 0.1), torch.full((M, 1), 2.0),
                     {"density": torch.rand(64, generator=g)}, occ, 4)
    leaves = {"table": master.clone()}
    radam_update(leaves, {"table": torch.ones_like(master)},
                 init_radam_state(leaves), 0.01)
    assert not any(launch_counts().values())


def test_reset_clears_every_count():
    reset_counts()
    count("tent_contract")
    count("nerf_small_fused.rows", 640)
    count("fused_radam.elements", 5)
    count("fused_radam.elements", 7)
    assert launch_counts() == {"tent_contract": 1, "nerf_small_fused.rows": 640,
                               "fused_radam.elements": 12}
    assert launch_counts()["group_scatter"] == 0  # never counted
    reset_counts()
    assert dict(launch_counts()) == {}


def test_launch_on_stream_counts_each_successful_launch(monkeypatch):
    """A launch counts once under its name; a refused one raises and
    counts nothing (the card's stream stood in for)."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    x = torch.zeros(4)
    reset_counts()
    for _ in range(3):
        launch_on_stream(lambda ptr, n, stream: 0, None, "k", (("x", x),), 4)
    with pytest.raises(RuntimeError, match="k launch failed: refused"):
        launch_on_stream(lambda ptr, n, stream: 9, lambda code: b"refused",
                         "k", (("x", x),), 4)
    assert launch_counts() == {"k": 3}
    reset_counts()
