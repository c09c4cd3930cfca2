"""The fused NeRFSmall query (models/mlp_fused.py) on the CPU: when a field
query takes the kernel, the weight pack's layout and its cache, the widths
of every grid configuration under configs/, and the eager path of
``query_field`` unchanged, bit for bit. The kernel itself runs on the card
(tests/test_torch_mlp_fused_cuda.py)."""

import glob
import os
from unittest import mock

import numpy as np
import pytest
import torch

from indoor_nerf_tpu_torch.models import mlp_fused
from indoor_nerf_tpu_torch.models.field import (
    FieldConfig,
    encode_position,
    encode_views,
    init_field_params,
    query_field,
)
from indoor_nerf_tpu_torch.models.mlp import init_nerf_big, init_nerf_small
from indoor_nerf_tpu_torch.models.mlp_fused import (
    SUPPORTED_INPUTS,
    SUPPORTED_VIEWS,
    fused_applies,
    nerf_small_fused,
    nerf_small_plain,
    pack_layout,
    pack_offsets,
    pack_weights,
    packed,
    unsupported_widths,
)
from indoor_nerf_tpu_torch.ops.blockhash import BlockHashConfig
from indoor_nerf_tpu_torch.ops.encoding import HashGridConfig
from indoor_nerf_tpu_torch.train import config as tconfig

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, _ROOT)
                 for p in glob.glob(os.path.join(_ROOT, "configs", "*.txt")))
CUDA = torch.device("cuda")
BBOX = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))


def _net(normals=True, seed=0, **widths):
    return init_nerf_small(torch.Generator().manual_seed(seed),
                           predict_normals=normals, **widths)


# -- dispatch -----------------------------------------------------------------

APPLIES = dict(device=CUDA, grad_enabled=False, train=False,
               compute_dtype=None, quantizing=False)


def test_fused_applies_to_an_inference_query_on_the_card():
    assert fused_applies(_net(), **APPLIES)
    assert fused_applies(_net(normals=False), **APPLIES)


@pytest.mark.parametrize("change", [
    {"grad_enabled": True},
    {"compute_dtype": torch.bfloat16},
    {"quantizing": True},
    {"train": True},
    {"device": torch.device("cpu")},
], ids=["grad", "bf16", "quantizer", "training_query", "cpu"])
def test_every_other_query_takes_the_eager_chain(change):
    """``training_query``: a query of a training step without autograd,
    as A-CAQ's unquantized anchor is."""
    assert not fused_applies(_net(), **{**APPLIES, **change})


def test_the_classic_nerf_takes_the_eager_chain():
    big = init_nerf_big(torch.Generator().manual_seed(0), use_viewdirs=True)
    assert not fused_applies(big, **APPLIES)


# -- the weight pack ----------------------------------------------------------

WIDTHS = [(i, v) for i in SUPPORTED_INPUTS for v in SUPPORTED_VIEWS]


@pytest.mark.parametrize("input_ch,views", WIDTHS)
@pytest.mark.parametrize("normals", [True, False])
def test_pack_layout_holds_each_weight_at_its_offset(normals, input_ch, views):
    net = _net(normals, input_ch=input_ch, input_ch_views=views)
    pack = pack_weights(net)
    offsets, size = pack_offsets(input_ch, views, normals)
    if (input_ch, views) == (32, 16):
        assert size == (10052 if normals else 9408)
    assert all(o % 4 == 0 for o in offsets + [size])  # 16-byte loads
    assert pack.numel() == size
    assert pack.dtype == torch.float32
    c0 = net.color_net[0]["w"]
    want = {"sigma_net.0.w": net.sigma_net[0]["w"],
            "sigma_net.1.w": net.sigma_net[1]["w"],
            "color_net.0.w[views]": c0[:views], "color_net.0.w[geo]": c0[views:],
            "color_net.1.w": net.color_net[1]["w"],
            "color_net.2.w": net.color_net[2]["w"]}
    if normals:
        want.update({f"normal_net.{i}.{k}": net.normal_net[i][k]
                     for i in (0, 1) for k in ("w", "b")})
    entries = pack_layout(input_ch, views, normals)
    assert [name for name, _ in entries] == list(want)
    for (name, shape), at in zip(entries, offsets):
        got = pack[at:at + int(np.prod(shape))].reshape(shape)
        w = want[name].detach()
        # A 3-wide output is padded to 4 with zeros.
        assert torch.equal(got[..., :w.shape[-1]], w), name
        assert not bool(got[..., w.shape[-1]:].any()), name


def test_pack_is_kept_until_a_weight_changes_in_place():
    net = _net()
    first = packed(net)
    assert packed(net) is first
    with torch.no_grad():
        net.color_net[1]["w"].mul_(2.0)
    second = packed(net)
    assert second is not first
    assert torch.equal(second, pack_weights(net))
    # A kernel's write through a pointer bumps no counter by itself; the
    # optimizer counts it (train/optim.py) as increment_version does here.
    with torch.no_grad():
        net.normal_net[1]["b"].data.add_(1.0)
    assert packed(net) is second
    torch.autograd.graph.increment_version(net.normal_net[1]["b"])
    assert torch.equal(packed(net), pack_weights(net))


def test_an_eager_optimizer_step_repacks():
    from indoor_nerf_tpu_torch.train.optim import (
        init_radam_state,
        named_leaves,
        radam_update,
    )

    net = _net()
    leaves = named_leaves({"coarse": net})
    state = init_radam_state(leaves)
    state["step"] = 10  # past the rectification threshold: p moves
    before = packed(net).clone()
    grads = {k: torch.ones_like(v) for k, v in leaves.items()}
    radam_update(leaves, grads, state, 1e-2)
    after = packed(net)
    assert not torch.equal(after, before)
    assert torch.equal(after, pack_weights(net))


# -- widths -------------------------------------------------------------------

@pytest.mark.parametrize("widths", [
    {"hidden_dim": 32}, {"input_ch": 24}, {"geo_feat_dim": 7},
    {"input_ch_views": 9}, {"hidden_dim_color": 128}, {"num_layers": 3}])
def test_other_widths_are_named_and_refused(widths):
    """The wrapper refuses them, so the dispatch keeps them on the eager
    chain, the path they ran before the kernel."""
    net = _net(**widths)
    assert "nerf_small_fused is built for" in unsupported_widths(net)
    assert not fused_applies(net, **APPLIES)
    # Meta tensors stand in for the card's: the refusal comes before any
    # launch.
    with pytest.raises(ValueError, match="nerf_small_fused is built for"):
        nerf_small_fused(net, torch.zeros(4, 32, device="meta"), None, 1,
                         torch.zeros(4, dtype=torch.bool, device="meta"))


@pytest.fixture(scope="module")
def scene_dirs(tmp_path_factory):
    from _torch_scenes import WRITERS

    return {kind: WRITERS[kind](tmp_path_factory.mktemp(kind))
            for kind in ("blender", "llff", "scannet")}


@pytest.mark.parametrize("path", CONFIGS)
def test_every_grid_config_builds_a_field_the_kernel_takes(path, scene_dirs):
    """Each configuration file's field, as the trainer and the server build
    it (the flagship's normal net from the structural priors included):
    every net of it has the kernel's widths, and its evaluation queries on
    the card take the kernel."""
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.train.trainer import (
        build_train_config,
        enable_normals,
    )

    kind = tconfig.parse_args(["--config", os.path.join(_ROOT, path)]
                              ).dataset_type
    args = tconfig.parse_args(["--config", os.path.join(_ROOT, path),
                               "--datadir", scene_dirs[kind]])
    enable_normals(args)
    fc = build_train_config(args, load_dataset(args)).render.field
    assert fc.uses_grid
    params = init_field_params(torch.Generator().manual_seed(0), fc)
    nets = [params[k] for k in ("coarse", "fine") if k in params]
    for net in nets:
        assert unsupported_widths(net) is None, path
        assert fused_applies(net, CUDA, False, False, fc.torch_compute_dtype,
                             False), path


# The parser's grid fields beyond configs/: (flags, whether the kernel
# takes them). The parser's defaults (--i_embed 1, no --use_viewdirs) and
# its other view encodings and level counts.
CLI_FIELDS = {
    "defaults": ([], True),
    "viewdirs": (["--use_viewdirs"], True),
    "pe_views": (["--use_viewdirs", "--i_embed_views", "0"], True),
    "8_levels": (["--n_levels", "8"], True),
    "8_levels_pe_views": (["--n_levels", "8", "--use_viewdirs",
                           "--i_embed_views", "0"], True),
    "block_hash": (["--i_embed", "3"], True),
    "normals": (["--predict_normals"], True),
    "12_levels": (["--n_levels", "12"], False),
    "pe_views_2": (["--use_viewdirs", "--i_embed_views", "0",
                    "--multires_views", "2"], False),
}


@pytest.mark.parametrize("name", sorted(CLI_FIELDS))
def test_cli_grid_fields_take_the_kernel_or_the_eager_chain(name, scene_dirs):
    """A field the parser builds from its flags: the kernel takes it where
    its widths are instantiated, and the eager chain, as before the kernel,
    where they are not; no width makes a query raise."""
    from indoor_nerf_tpu_torch.data.load import load_dataset
    from indoor_nerf_tpu_torch.train.trainer import build_train_config

    flags, takes = CLI_FIELDS[name]
    args = tconfig.parse_args(["--dataset_type", "blender", "--datadir",
                               scene_dirs["blender"], *flags])
    fc = build_train_config(args, load_dataset(args)).render.field
    net = init_field_params(torch.Generator().manual_seed(0), fc)["coarse"]
    assert (unsupported_widths(net) is None) == takes
    assert fused_applies(net, CUDA, False, False, fc.torch_compute_dtype,
                         False) == takes


def test_acaq_anchor_is_a_training_query():
    """A-CAQ's MDL anchor renders the batch again without autograd and
    without quantizers; it passes ``train``, so on the card it keeps the
    eager chain, as every query of a training step does."""
    from indoor_nerf_tpu_torch.models import field as field_mod
    from indoor_nerf_tpu_torch.train.step import (
        acaq_active,
        draw_step,
        init_train_state,
        train_step,
    )
    from indoor_nerf_tpu_torch.train.trainer import one_batch

    args = tconfig.parse_args([
        "--flagship", "--dataset_type", "synthetic", "--use_viewdirs",
        "--white_bkgd", "--n_levels", "4", "--finest_res", "32",
        "--log2_hashmap_size", "12", "--occ_resolution", "16",
        "--N_rand", "64", "--device", "cpu", "--use_quantization",
        "--use_acaq", "--acaq_start_iter", "10"])
    cpu = torch.device("cpu")
    cfg, batch = one_batch(args, cpu)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, cpu)
    state["step"] = 10
    assert acaq_active(cfg, 10)
    assert cfg.render.field.quant.target_metric is None
    seen = []

    def recorder(net, device, grad_enabled, train, *rest):
        # What the predicate says for the same query on the card.
        on_card = fused_applies(net, CUDA, grad_enabled, train, *rest)
        seen.append((grad_enabled, train, on_card))
        return on_card and device.type == "cuda"

    draws = draw_step(torch.Generator().manual_seed(1), cfg, 10, 64)
    with mock.patch.object(field_mod, "fused_applies", side_effect=recorder):
        train_step(state, batch, cfg, draws=draws)
    assert (False, True, False) in seen  # the anchor
    assert all(train and not on_card for _, train, on_card in seen)


# -- the eager path -----------------------------------------------------------

FIELDS = {
    "flagship": FieldConfig(
        block_grid=BlockHashConfig(BBOX[0], BBOX[1], n_levels=8,
                                   n_features_per_level=4, log2_rows=8,
                                   base_resolution=8, finest_resolution=64,
                                   block_size=3, gather_dtype="bfloat16",
                                   scatter_dtype="bfloat16"),
        i_embed=3, predict_normals=True),
    "hashgrid": FieldConfig(
        grid=HashGridConfig(BBOX[0], BBOX[1], log2_hashmap_size=10,
                            finest_resolution=64), i_embed=1),
}


def _tile(fc, r=24, s=9, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = init_field_params(g, fc)
    # A trained field's magnitude, so the rows are not all alike.
    params["table"] = torch.randn(params["table"].shape, generator=g)
    # Some samples outside the box: keep is False there.
    pts = torch.rand((r, s, 3), generator=g) * 3.6 - 1.8
    dirs = torch.nn.functional.normalize(torch.randn((r, 3), generator=g), dim=-1)
    bias = 0.1 * torch.randn((r, 16), generator=g)
    return params, pts, dirs, bias


def _parent_query(params, pts, dirs, fc, step=None, view_bias=None):
    """``query_field``'s flat-encode path as the parent commit wrote it."""
    r, s, _ = pts.shape
    feats, keep, _ = encode_position(pts.reshape(-1, 3), params, fc, None,
                                     True, step)
    vf = encode_views(dirs, fc.i_embed_views, fc.multires_views)
    if fc.view_anneal_iters > 0 and step is not None:
        vf = vf * min(1.0, step / fc.view_anneal_iters)
    if view_bias is not None:
        vf = vf + view_bias
    view_feats = vf[:, None, :].expand(r, s, vf.shape[-1]).reshape(r * s, -1)
    raw = params["coarse"](feats, view_feats, fc.torch_compute_dtype)
    sigma = torch.where(keep, raw[..., 3], 0.0)
    raw = torch.cat([raw[..., :3], sigma[..., None], raw[..., 4:]], dim=-1)
    return raw.reshape(r, s, -1), keep


@pytest.mark.parametrize("grad", [True, False], ids=["grad", "inference"])
@pytest.mark.parametrize("name", sorted(FIELDS))
def test_eager_query_field_is_the_parents_bit_for_bit(name, grad):
    fc = FIELDS[name]
    params, pts, dirs, bias = _tile(fc)
    mlp_fused.reset_counts()
    with torch.set_grad_enabled(grad):
        got, _ = query_field(params, "coarse", pts, dirs, fc, None, None,
                             False, bias)
        want, keep = _parent_query(params, pts, dirs, fc, view_bias=bias)
    assert mlp_fused.launch_count() == 0
    assert not bool(keep.all()) and bool(keep.any())
    assert got.shape == (24, 9, 7 if fc.predict_normals else 4)
    assert torch.equal(got, want)


def test_eager_training_query_is_the_parents_bit_for_bit():
    """A training query (a step: the view anneal) with grad."""
    import dataclasses

    fc = dataclasses.replace(FIELDS["flagship"], view_anneal_iters=100)
    params, pts, dirs, _ = _tile(fc, seed=3)
    got, _ = query_field(params, "coarse", pts, dirs, fc, 40)
    want, _ = _parent_query(params, pts, dirs, fc, step=40)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_plain_chain_is_the_eager_query(name):
    """The kernel's yardstick, ``nerf_small_plain`` (and the wrapper on CPU
    tensors), computes what the eager query computes, bit for bit."""
    fc = FIELDS[name]
    params, pts, dirs, bias = _tile(fc, seed=1)
    with torch.inference_mode():
        want, keep = _parent_query(params, pts, dirs, fc, view_bias=bias)
        feats, _, _ = encode_position(pts.reshape(-1, 3), params, fc, None,
                                      False, None)
        vf = encode_views(dirs, fc.i_embed_views, fc.multires_views) + bias
        for fn in (nerf_small_plain, nerf_small_fused):
            got = fn(params["coarse"], feats, vf, 9, keep)
            assert torch.equal(got.reshape(want.shape), want)


def test_query_field_hands_the_kernel_per_ray_view_features():
    """On the card's route ``query_field`` passes the ray's view features
    (after the anneal and the latent), the sample count and the keep mask,
    and reshapes what comes back; the wrapper's stand-in here is the plain
    chain, so the result is the eager query's."""
    fc = FIELDS["flagship"]
    params, pts, dirs, bias = _tile(fc, seed=2)
    seen = []

    def stand_in(net, feats, vf, samples, keep):
        seen.append((tuple(feats.shape), tuple(vf.shape), samples,
                     feats.is_contiguous() and vf.is_contiguous()))
        return nerf_small_plain(net, feats, vf, samples, keep)

    with torch.inference_mode(), \
            mock.patch("indoor_nerf_tpu_torch.models.field.fused_applies",
                       return_value=True), \
            mock.patch("indoor_nerf_tpu_torch.models.field.nerf_small_fused",
                       stand_in):
        got, _ = query_field(params, "coarse", pts, dirs, fc, None, None,
                             False, bias)
        want, _ = _parent_query(params, pts, dirs, fc, view_bias=bias)
    assert seen == [((24 * 9, 32), (24, 16), 9, True)]
    assert torch.equal(got, want)
