"""Move a JAX train state's serving leaves into the port and back.

The JAX state, fetched to numpy, is a nested dict::

    {"params": {"table": [L*R, F*lpf],
                "coarse": {"sigma_net": [{"w": [in, out]}, ...],
                           "color_net": [{"w": [in, out]}, ...]},
                ["fine": {...}]},
     "occ": {"density": [res^3]} or None}

The port keeps the same layouts (weights ``[in, out]``), so the leaves
move across without a transpose and come back bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from indoor_nerf_tpu_torch.models.mlp import NeRFSmall

Tree = Dict[str, Any]
_MLPS = ("coarse", "fine")


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(device)


def _nerf_small_from_numpy(tree: Tree, device) -> NeRFSmall:
    def layers(key):
        out = []
        for layer in tree[key]:
            if set(layer) != {"w"}:
                raise ValueError(f"{key} layers hold {sorted(layer)}; "
                                 "NeRFSmall layers are bias-free")
            out.append(nn.ParameterDict({"w": nn.Parameter(
                _tensor(layer["w"], device), requires_grad=False)}))
        return out

    return NeRFSmall(layers("sigma_net"), layers("color_net"))


def params_from_numpy(tree: Tree, device=None) -> Tree:
    """JAX state (numpy leaves) -> ``{"params": {...}, "occ": {...} | None}``."""
    params = {"table": _tensor(tree["params"]["table"], device)}
    for name in _MLPS:
        if name in tree["params"]:
            params[name] = _nerf_small_from_numpy(tree["params"][name], device)
    occ = tree.get("occ")
    return {
        "params": params,
        "occ": None if occ is None else {"density": _tensor(occ["density"], device)},
    }


def params_to_numpy(state: Tree) -> Tree:
    """The inverse of ``params_from_numpy``: port state -> numpy leaves."""
    def arr(t):
        return t.detach().cpu().numpy()

    params = {"table": arr(state["params"]["table"])}
    for name in _MLPS:
        if name in state["params"]:
            mlp = state["params"][name]
            params[name] = {
                "sigma_net": [{"w": arr(l["w"])} for l in mlp.sigma_net],
                "color_net": [{"w": arr(l["w"])} for l in mlp.color_net],
            }
    occ = state.get("occ")
    return {
        "params": params,
        "occ": None if occ is None else {"density": arr(occ["density"])},
    }
