"""Move a JAX train state into the port and back.

The JAX state, fetched to numpy, is a nested dict::

    {"params": {"table": [L*R, F*lpf],
                "coarse": {"sigma_net": [{"w": [in, out]}, ...],
                           "color_net": [{"w": [in, out]}, ...]},
                ["fine": {...}]},
     "occ": {"density": [res^3]} or None,
     # the training leaves (state_from_numpy / state_to_numpy):
     "opt": {"mu": <params tree>, "nu": <params tree>, "step": int},
     "step": int, "best_loss": f32, "loss_ema": f32, "loss_ema_slow": f32}

The port keeps the same layouts (weights ``[in, out]``), so the leaves
move across without a transpose and come back bit for bit. The RAdam
moments are keyed by the port's leaf names (``train/optim.py``), which
are the JAX pytree paths joined by dots.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from indoor_nerf_tpu_torch.models.mlp import NeRFSmall
from indoor_nerf_tpu_torch.train.optim import named_leaves
from indoor_nerf_tpu_torch.train.step import make_train_state

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
                _tensor(layer["w"], device))}))
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


_SCALARS = ("best_loss", "loss_ema", "loss_ema_slow")


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    """A numpy params tree -> {dotted path: leaf} (the port's leaf names)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _unflatten_like(template, flat: Dict[str, np.ndarray], prefix=""):
    """The inverse of ``_flatten`` over ``template``'s structure."""
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}.{k}" if prefix else k)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_unflatten_like(v, flat, f"{prefix}.{i}")
                for i, v in enumerate(template)]
    return flat[prefix]


def state_from_numpy(tree: Tree, device=None) -> Tree:
    """A whole JAX train state (numpy leaves) -> the port's train state."""
    base = params_from_numpy(tree, device)
    state = make_train_state(base["params"], base["occ"])
    for key in ("mu", "nu"):
        flat = _flatten(tree["opt"][key])
        for name, t in state["opt"][key].items():
            t.copy_(_tensor(flat[name], device))
    state["opt"]["step"] = int(tree["opt"]["step"])
    state["step"] = int(tree["step"])
    for key in _SCALARS:
        state[key] = _tensor(tree[key], device)
    return state


def state_to_numpy(state: Tree) -> Tree:
    """The inverse of ``state_from_numpy``: port train state -> numpy leaves."""
    out = params_to_numpy(state)
    names = set(named_leaves(state["params"]))
    moments = {}
    for key in ("mu", "nu"):
        flat = {k: v.detach().cpu().numpy() for k, v in state["opt"][key].items()}
        if set(flat) != names:
            raise ValueError(f"opt {key} holds {sorted(flat)}, params {sorted(names)}")
        moments[key] = _unflatten_like(out["params"], flat)
    out["opt"] = {**moments, "step": np.int32(state["opt"]["step"])}
    out["step"] = np.int32(state["step"])
    for key in _SCALARS:
        out[key] = state[key].detach().cpu().numpy()
    return out
