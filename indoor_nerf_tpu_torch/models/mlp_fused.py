"""NeRFSmall's query after the encode in one CUDA kernel
(``csrc/nerf_small_fused.cu``): the sigma net, the colour net on the
ray's view features and the geometry features, the normal net where the
model has one, and ``query_field``'s glue (sigma zeroed outside the box),
for every sample row of a tile.

Two implementations of the same function live here:

- ``nerf_small_plain``: the eager chain (the view features broadcast to the
  rows, ``apply_nerf_small``, the mask). The reference the kernel is held
  against, on the CPU and on the card.
- the kernel, through ``nerf_small_fused``: float32 FFMA, every dot
  product summed in ascending order, one launch a call. CPU tensors take
  the plain chain; CUDA tensors launch the kernel or raise (widths it was
  not built for, a wrong dtype, a non-contiguous input). There is no
  fallback from a failed build or launch to the plain chain.

``fused_applies`` decides from what a query can observe whether
``query_field`` takes the kernel: CUDA params, no autograd, not a training
step's query, NeRFSmall at widths the kernel was built for
(``SUPPORTED_INPUTS`` x ``SUPPORTED_VIEWS``), float32 products, no fake
quantizer. Every other query (training steps and A-CAQ's unquantized
anchor inside them, ``--precision bf16``, the classic NeRF, other widths,
the CPU) runs the eager chain unchanged. Nerfacto's queries
(``nerfacto_query``, with its appearance input) do not reach
``query_field``.

The kernel reads the weights from one packed float32 buffer
(``pack_layout``), made once per set of weights and kept on the module,
keyed by the weights' pointers and version counters: an in-place update
(an optimizer step) makes the next query pack again.
"""

from __future__ import annotations

import ctypes
import itertools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from indoor_nerf_tpu_torch.cuda_build import count, launch_on_stream, load_library
from indoor_nerf_tpu_torch.models.mlp import NeRFSmall, apply_nerf_small

# The widths the kernel is built for (csrc/nerf_small_fused.cu), one
# instantiation for each input and view width, with and without the normal
# net: the inputs of 8 or 16 levels of 2 features and of 8 of 4 (the block
# hash's), and the view features of no --use_viewdirs, of SH of degree 4
# and of the positional encoding at --multires_views 4 (the parser's
# defaults). Hidden 64 and geometry 15 are every grid field's.
SUPPORTED_INPUTS = (16, 32)
SUPPORTED_VIEWS = (0, 16, 27)
HIDDEN, GEO, COLOR_HIDDEN = 64, 15, 64


def net_widths(net: NeRFSmall) -> Tuple[int, int]:
    """(input features, view features) of ``net``."""
    return (net.sigma_net[0]["w"].shape[0],
            net.color_net[0]["w"].shape[0] - GEO)


def pack_layout(input_ch: int, views: int, normals: bool
                ) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    """The pack: (name, (rows, cols)) in order, each [in][out] as y = x @
    w; a 3-wide output padded to 4 with zeros. The normal net's four
    entries come last."""
    layout = (
        ("sigma_net.0.w", (input_ch, HIDDEN)),
        ("sigma_net.1.w", (HIDDEN, 1 + GEO)),
        ("color_net.0.w[views]", (views, COLOR_HIDDEN)),
        ("color_net.0.w[geo]", (GEO, COLOR_HIDDEN)),
        ("color_net.1.w", (COLOR_HIDDEN, COLOR_HIDDEN)),
        ("color_net.2.w", (COLOR_HIDDEN, 4)),
    )
    if normals:
        layout += (
            ("normal_net.0.w", (GEO, HIDDEN // 2)),
            ("normal_net.0.b", (HIDDEN // 2,)),
            ("normal_net.1.w", (HIDDEN // 2, 4)),
            ("normal_net.1.b", (4,)),
        )
    return layout


def pack_offsets(input_ch: int, views: int, normals: bool
                 ) -> Tuple[List[int], int]:
    """(each entry's offset in floats, the pack's size)."""
    offsets, at = [], 0
    for _, shape in pack_layout(input_ch, views, normals):
        offsets.append(at)
        at += math.prod(shape)
    return offsets, at


def _expected_shapes(input_ch: int, views: int, normals: bool
                     ) -> Dict[str, Tuple[int, ...]]:
    """The shape of each of a model's weights that the kernel takes."""
    shapes = {"sigma_net.0.w": (input_ch, HIDDEN),
              "sigma_net.1.w": (HIDDEN, 1 + GEO),
              "color_net.0.w": (views + GEO, COLOR_HIDDEN),
              "color_net.1.w": (COLOR_HIDDEN, COLOR_HIDDEN),
              "color_net.2.w": (COLOR_HIDDEN, 3)}
    if normals:
        shapes.update({"normal_net.0.w": (GEO, HIDDEN // 2),
                       "normal_net.0.b": (HIDDEN // 2,),
                       "normal_net.1.w": (HIDDEN // 2, 3),
                       "normal_net.1.b": (3,)})
    return shapes


def unsupported_widths(net: NeRFSmall) -> Optional[str]:
    """Why the kernel cannot run ``net`` (its weights' names and shapes
    against the widths it is built for), or None where it can."""
    have = {name: tuple(p.shape) for name, p in net.named_parameters()}
    input_ch, views = net_widths(net)
    if input_ch in SUPPORTED_INPUTS and views in SUPPORTED_VIEWS:
        want = _expected_shapes(input_ch, views, net.predict_normals)
        if have == want:
            return None
    return (f"nerf_small_fused is built for inputs {SUPPORTED_INPUTS} and "
            f"view features {SUPPORTED_VIEWS}, with hidden {HIDDEN}, "
            f"geometry {GEO} and colour hidden {COLOR_HIDDEN}; the model "
            f"has {have}")


def pack_weights(net: NeRFSmall) -> torch.Tensor:
    """The model's weights in ``pack_layout`` order, flat float32 on their
    device (plain tensor code)."""
    _, views = net_widths(net)
    s0, s1 = (layer["w"] for layer in net.sigma_net)
    c0, c1, c2 = (layer["w"] for layer in net.color_net)
    parts = [s0, s1, c0[:views], c0[views:], c1, F.pad(c2, (0, 1))]
    if net.predict_normals:
        n0, n1 = net.normal_net
        parts += [n0["w"], n0["b"], F.pad(n1["w"], (0, 1)),
                  F.pad(n1["b"], (0, 1))]
    return torch.cat([p.detach().float().reshape(-1) for p in parts])


def _version(t: torch.Tensor) -> int:
    # An inference tensor keeps no version counter; it cannot change
    # outside inference mode.
    return -1 if t.is_inference() else t._version


def packed(net: NeRFSmall) -> torch.Tensor:
    """``pack_weights(net)``, made once per set of weights and kept on the
    module, keyed by each weight's pointer and version counter."""
    key = tuple((p.data_ptr(), _version(p)) for p in net.parameters())
    cached = net.__dict__.get("_fused_pack")
    if cached is None or cached[0] != key:
        cached = (key, pack_weights(net))
        net.__dict__["_fused_pack"] = cached
    return cached[1]


def fused_applies(net, device: torch.device, grad_enabled: bool,
                  train: bool, compute_dtype: Optional[torch.dtype],
                  quantizing: bool) -> bool:
    """Whether a field query takes the kernel: every condition holds. A
    query of a training step (``train``: A-CAQ's unquantized anchor, run
    without autograd, is one) keeps the eager chain, as does a net of
    widths the kernel was not built for."""
    return (device.type == "cuda" and not grad_enabled and not train
            and isinstance(net, NeRFSmall) and compute_dtype is None
            and not quantizing and unsupported_widths(net) is None)


def mask_sigma(raw: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``raw`` with sigma (channel 3) zeroed where ``keep`` is False."""
    sigma = torch.where(keep, raw[..., 3], 0.0)
    return torch.cat([raw[..., :3], sigma[..., None], raw[..., 4:]], dim=-1)


def nerf_small_plain(net: NeRFSmall, feats: torch.Tensor,
                     vf: Optional[torch.Tensor], samples: int,
                     keep: torch.Tensor) -> torch.Tensor:
    """The eager chain: ``vf [R, D]`` broadcast to the ``R * samples``
    rows of ``feats``, NeRFSmall, sigma zeroed where ``keep`` is False."""
    views = None
    if vf is not None:
        views = vf[:, None, :].expand(vf.shape[0], samples,
                                      vf.shape[-1]).reshape(-1, vf.shape[-1])
    return mask_sigma(apply_nerf_small(net, feats, views), keep)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: Tuple[int, ...]) -> None:
    if t.dtype != dtype:
        raise TypeError(f"nerf_small_fused takes {name} as {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"nerf_small_fused takes {name} of shape {shape}, "
                         f"got {tuple(t.shape)}")


def nerf_small_fused(net: NeRFSmall, feats: torch.Tensor,
                     vf: Optional[torch.Tensor], samples: int,
                     keep: torch.Tensor) -> torch.Tensor:
    """``nerf_small_plain``'s raw ``[R * samples, 7 or 4]``: on the CPU the
    plain chain; on a CUDA device the kernel, one launch on the current
    stream, without a synchronize, or a raise."""
    if feats.device.type == "cpu":
        return nerf_small_plain(net, feats, vf, samples, keep)
    reason = unsupported_widths(net)
    if reason is not None:
        raise ValueError(reason)
    input_ch, views = net_widths(net)
    if (vf is None) != (views == 0):
        raise ValueError(f"the model takes {views} view features a ray; "
                         f"the query has {'none' if vf is None else 'some'}")
    n = feats.shape[0]
    if samples < 1 or n % samples:
        raise ValueError(f"{n} rows are not rays of {samples} samples")
    _check("feats", feats, torch.float32, (n, input_ch))
    if vf is None:  # the kernel reads no view pointer
        vf = feats.new_empty((0,))
    else:
        _check("vf", vf, torch.float32, (n // samples, views))
    _check("keep", keep, torch.bool, (n,))
    out = torch.empty((n, 7 if net.predict_normals else 4),
                      dtype=torch.float32, device=feats.device)
    if n == 0:
        return out
    pack = packed(net)
    lib = load_library("nerf_small_fused", check_layout).lib
    launch_on_stream(lib.nerf_small_fused, lib.nerf_small_fused_error_string,
                     "nerf_small_fused",
                     (("feats", feats), ("vf", vf), ("keep", keep),
                      ("pack", pack), ("out", out)),
                     n, samples, input_ch, views, int(net.predict_normals),
                     align=16)
    count("nerf_small_fused.rows", n)
    return out


def check_layout(lib) -> None:
    """Raise unless the pack layout of each of the built library's
    instantiations is ``pack_offsets``'."""
    values = (ctypes.c_int * 16)()
    for input_ch, views, normals in itertools.product(
            SUPPORTED_INPUTS, SUPPORTED_VIEWS, (True, False)):
        n = lib.nerf_small_fused_layout(input_ch, views, int(normals),
                                        values, 16)
        # Every offset is named, the normal net's too; then the size.
        offsets, _ = pack_offsets(input_ch, views, True)
        _, size = pack_offsets(input_ch, views, normals)
        if list(values[:n]) != offsets + [size]:
            raise RuntimeError(
                "csrc/nerf_small_fused.cu's pack layout differs from "
                f"models/mlp_fused.py's at input {input_ch}, views "
                f"{views}, normals {normals}")


def blocks_per_sm(input_ch: int, views: int, normals: bool) -> int:
    """The kernel's blocks resident on one SM of the current device."""
    lib = load_library("nerf_small_fused", check_layout).lib
    n = lib.nerf_small_fused_blocks_per_sm(input_ch, views, int(normals))
    if n < 1:
        raise RuntimeError(f"nerf_small_fused fits no block on an SM ({n})")
    return n
