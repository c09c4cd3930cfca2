"""Move a JAX train state into the port and back.

The JAX state, fetched to numpy, is a nested dict::

    {"params": {["table": [L*R, F*lpf] (block grid) or [L*T, F] (hash),]
                "coarse": {"sigma_net": [{"w": [in, out]}, ...],
                           "color_net": [{"w": [in, out]}, ...],
                           ["normal_net": [{"w", "b"}, {"w", "b"}]]}
                          (NeRFSmall) or
                          {"pts_linears": [{"w", "b"}, ...],
                           "feature_linear", "alpha_linear",
                           "views_linears": [...], "rgb_linear"
                           | "output_linear"} (NeRFBig),
                ["fine": {...}]},
     "occ": {"density": [res^3]} or None,
     # the training leaves (state_from_numpy / state_to_numpy):
     "opt": {"mu": <params tree>, "nu": <params tree>, "step": int},
     ["ema": <params tree>] (the params EMA of ``--ema_decay``),
     "step": int, "best_loss": f32, "loss_ema": f32, "loss_ema_slow": f32}

The port keeps the same layouts (weights ``[in, out]``), so the leaves
move across without a transpose and come back bit for bit. The RAdam
moments are keyed by the port's leaf names (``train/optim.py``), which
are the JAX pytree paths joined by dots.

``load_jax_checkpoint`` reads a file written by the JAX package's
``save_checkpoint`` into that numpy tree without jax or flax, and
``load_jax_baked`` a ``save_baked`` snapshot; ``baked_from_numpy`` /
``baked_to_numpy`` move a baked snapshot (``render/baked.py``) across.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from indoor_nerf_tpu_torch.models.mlp import NeRFBig, NeRFSmall
from indoor_nerf_tpu_torch.train.optim import named_leaves
from indoor_nerf_tpu_torch.train.step import make_train_state

Tree = Dict[str, Any]
_MLPS = ("coarse", "fine")


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(device)


def _linear_from_numpy(layer: Tree, device) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(_tensor(v, device))
                             for k, v in layer.items()})


def _nerf_small_from_numpy(tree: Tree, device) -> NeRFSmall:
    def layers(key, biased):
        for layer in tree[key]:
            if set(layer) != ({"w", "b"} if biased else {"w"}):
                raise ValueError(
                    f"{key} layers hold {sorted(layer)}; NeRFSmall's "
                    + ("normal layers are biased" if biased else
                       "sigma and color layers are bias-free"))
        return [_linear_from_numpy(layer, device) for layer in tree[key]]

    normal_net = layers("normal_net", True) if "normal_net" in tree else None
    return NeRFSmall(layers("sigma_net", False), layers("color_net", False),
                     normal_net)


_BIG_HEADS = ("feature_linear", "alpha_linear", "views_linears", "rgb_linear",
              "output_linear")


def _nerf_big_from_numpy(tree: Tree, device) -> NeRFBig:
    heads = {}
    for name in _BIG_HEADS:
        if name in tree:
            layer = tree[name]
            heads[name] = ([_linear_from_numpy(l, device) for l in layer]
                           if name == "views_linears"
                           else _linear_from_numpy(layer, device))
    return NeRFBig([_linear_from_numpy(l, device) for l in tree["pts_linears"]],
                   heads)


def _mlp_from_numpy(tree: Tree, device):
    if "pts_linears" in tree:
        return _nerf_big_from_numpy(tree, device)
    return _nerf_small_from_numpy(tree, device)


def _mlp_to_numpy(mlp) -> Tree:
    """A NeRFSmall or NeRFBig as its JAX tree of numpy leaves."""
    def arr(t):
        return t.detach().cpu().numpy()

    def layer(p):
        return {k: arr(v) for k, v in p.items()}

    if isinstance(mlp, NeRFSmall):
        out = {"sigma_net": [layer(l) for l in mlp.sigma_net],
               "color_net": [layer(l) for l in mlp.color_net]}
        if mlp.predict_normals:
            out["normal_net"] = [layer(l) for l in mlp.normal_net]
        return out
    out = {"pts_linears": [layer(l) for l in mlp.pts_linears]}
    for name in _BIG_HEADS:
        if hasattr(mlp, name):
            head = getattr(mlp, name)
            out[name] = ([layer(l) for l in head] if name == "views_linears"
                         else layer(head))
    return out


def _params_tree_from_numpy(tree: Tree, device) -> Tree:
    params = {}
    if "table" in tree:
        params["table"] = _tensor(tree["table"], device)
    for name in _MLPS:
        if name in tree:
            params[name] = _mlp_from_numpy(tree[name], device)
    return params


def _params_tree_to_numpy(params: Tree) -> Tree:
    out = {}
    if "table" in params:
        out["table"] = params["table"].detach().cpu().numpy()
    for name in _MLPS:
        if name in params:
            out[name] = _mlp_to_numpy(params[name])
    return out


def params_from_numpy(tree: Tree, device=None) -> Tree:
    """JAX state (numpy leaves) -> ``{"params": {...}, "occ": {...} | None}``."""
    params = _params_tree_from_numpy(tree["params"], device)
    occ = tree.get("occ")
    return {
        "params": params,
        "occ": None if occ is None else {"density": _tensor(occ["density"], device)},
    }


def params_to_numpy(state: Tree) -> Tree:
    """The inverse of ``params_from_numpy``: port state -> numpy leaves."""
    occ = state.get("occ")
    return {
        "params": _params_tree_to_numpy(state["params"]),
        "occ": None if occ is None else {
            "density": occ["density"].detach().cpu().numpy()},
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
    """A whole JAX train state (numpy leaves) -> the port's train state,
    with the params EMA where the tree holds one."""
    base = params_from_numpy(tree, device)
    state = make_train_state(base["params"], base["occ"])
    if tree.get("ema") is not None:
        ema = _params_tree_from_numpy(tree["ema"], device)
        for t in named_leaves(ema).values():
            t.requires_grad_(False)
        state["ema"] = ema
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
    if state.get("ema") is not None:
        out["ema"] = _params_tree_to_numpy(state["ema"])
    out["step"] = np.int32(state["step"])
    for key in _SCALARS:
        out[key] = state[key].detach().cpu().numpy()
    return out


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (any 2-byte dtype) as the float32 they denote."""
    return (bits.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def _flax_array(data: bytes, msgpack) -> np.ndarray:
    """flax's ndarray encoding: a packed ``(shape, dtype name, bytes)``.
    numpy has no bfloat16: such an array comes back as float32."""
    shape, name, buf = msgpack.unpackb(data, raw=True)
    name = name.decode()
    if name == "bfloat16":
        return _bf16_bits_to_f32(np.frombuffer(buf, np.uint16)).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _flax_tree(node):
    """Undo flax's state-dict forms: a list is a map keyed ``"0"``,
    ``"1"``, ... (back to a list, in index order), an array over 1 GiB a
    map of chunks."""
    if not isinstance(node, dict):
        return node
    node = {k: _flax_tree(v) for k, v in node.items()}
    if "__msgpack_chunked_array__" in node:
        return np.concatenate(node["chunks"]).reshape(node["shape"])
    if node and set(node) == {str(i) for i in range(len(node))}:
        return [node[str(i)] for i in range(len(node))]
    return node


def load_flax_msgpack(path: str) -> Tree:
    """A flax ``msgpack_serialize`` / ``to_bytes`` file as nested dicts and
    lists with numpy leaves. flax itself is not imported (the card's machine
    has none); the ``msgpack`` package is, and must be installed."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError(
            f"{path} is a flax msgpack file; reading it needs the 'msgpack' "
            "package, which is not installed here") from e

    def ext_hook(code, data):
        if code == 1:  # ndarray
            return _flax_array(data, msgpack)
        if code == 3:  # numpy scalar
            return _flax_array(data, msgpack)[()]
        raise ValueError(f"{path}: flax msgpack ext type {code}")

    with open(path, "rb") as f:
        raw = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    return _flax_tree(raw)


def load_jax_checkpoint(path: str) -> Tree:
    """A checkpoint written by the JAX package's ``save_checkpoint`` as the
    numpy tree ``state_from_numpy`` takes, the params EMA (``ema``)
    included where it holds one.

    The JAX state also holds ``quant`` (A-CAQ) and ``infl_ema`` (A-CAQ's
    inflation statistic), which the port has not ported. ``None`` and the
    statistic are dropped; a checkpoint that holds a trained ``quant`` is
    refused, never read without it."""
    tree = load_flax_msgpack(path)
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path}: not a train state (no 'params')")
    if tree.get("quant") is not None:
        raise NotImplementedError(
            f"{path} holds a trained 'quant' state, which comes with "
            "ROADMAP.md Queue 1 item 5b (A-CAQ and the int8 gather); "
            "importing the checkpoint without it would drop trained state")
    keep = ("params", "opt", "occ", "step") + _SCALARS
    out = {k: tree[k] for k in keep if k in tree}
    if tree.get("ema") is not None:
        out["ema"] = tree["ema"]
    return out


_BAKED_ARRAYS = ("sigma_table", "voxel_geo", "block_max", "sigma_scale",
                 "geo_scale")


def baked_from_numpy(tree: Tree, device=None) -> Tree:
    """A baked snapshot with numpy leaves (``{"sigma_table", "voxel_geo",
    "block_max", "color_net": [{"w"}...], ["sigma_scale"], ["geo_scale"],
    "config": BakedConfig or its dict}``, as the JAX ``bake_field`` returns
    it after ``np.asarray``) -> the port's snapshot on ``device``.

    Each table is stored as ``config.table_dtype`` says. bfloat16 tables may
    arrive as float32 (rounded here; exact for values that were bfloat16) or
    as a 2-byte bfloat16 numpy array (its bits are taken as they are)."""
    from indoor_nerf_tpu_torch.render.baked import BakedConfig

    cfg = tree["config"]
    if not isinstance(cfg, BakedConfig):
        cfg = dict(cfg) if isinstance(cfg, dict) else dataclasses.asdict(cfg)
        cfg["bbox_min"] = tuple(float(v) for v in cfg["bbox_min"])
        cfg["bbox_max"] = tuple(float(v) for v in cfg["bbox_max"])
        # Snapshots written before the sqrt sigma encoding are log1p.
        cfg.setdefault("sigma_enc", "log1p")
        cfg = BakedConfig(**cfg)
    float_dtype = torch.float32 if cfg.table_dtype == "float32" else torch.bfloat16
    want = {"sigma_table": torch.int8 if cfg.sigma_quantized else float_dtype,
            "voxel_geo": torch.int8 if cfg.geo_quantized else float_dtype}
    out: Tree = {"config": cfg}
    for key in _BAKED_ARRAYS:
        if key not in tree:
            continue
        a = np.asarray(tree[key])
        if a.dtype.name == "bfloat16":
            a = _bf16_bits_to_f32(a)
        t = torch.from_numpy(np.array(a, copy=True))
        out[key] = t.to(want.get(key, torch.float32)).to(device)
    out["color_net"] = [{"w": _tensor(layer["w"], device)}
                        for layer in tree["color_net"]]
    return out


def baked_to_numpy(baked: Tree) -> Tree:
    """The inverse of ``baked_from_numpy``. bfloat16 tables come back as
    float32 of the same values (numpy has no bfloat16); ``config`` says what
    the storage dtype was."""
    out: Tree = {"config": baked["config"]}
    for key in _BAKED_ARRAYS:
        if key in baked:
            t = baked[key].detach().cpu()
            out[key] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    out["color_net"] = [{"w": layer["w"].detach().cpu().numpy()}
                        for layer in baked["color_net"]]
    return out


def load_jax_baked(path: str, device=None) -> Tree:
    """A snapshot written by the JAX package's ``save_baked`` (flax
    msgpack: ``{"arrays": ..., "config": ...}``) as the port's snapshot."""
    obj = load_flax_msgpack(path)
    if not isinstance(obj, dict) or set(obj) != {"arrays", "config"}:
        raise ValueError(f"{path}: not a baked snapshot of the JAX package")
    return baked_from_numpy({**obj["arrays"], "config": obj["config"]}, device)
