"""Checkpoint save / auto-resume (utils/checkpoint.py of the JAX package),
with the same names and directory semantics.

Checkpoints live in ``<basedir>/<mangled expname>/`` as ``{step:06d}.ckpt``;
the newest is loaded unless ``--no_reload``, ``--ft_path`` pins one file, and
``best.ckpt`` is never picked by auto-resume.

The port's own payload is the whole train state as one flat dict of CPU
tensors and plain ints, keyed by dotted leaf paths (``params.table``,
``params.coarse.sigma_net.0.w``, ``params.appearance`` (the latents of
``--use_appearance``), ``opt.mu.table``, ``opt.step``,
``occ.density``, ``ema.table`` (the params EMA of ``--ema_decay``),
``quant.embed.soft_bits`` (the A-CAQ quantizers of a quantized field),
``step``, ``best_loss``, ``infl_ema``, nerfacto's ``proposal_since``, ...), written with ``torch.save``
and read with ``weights_only=True``: no pickled classes. ``restore_checkpoint``
also reads a checkpoint written by the JAX package (flax msgpack), which it
tells apart by the file's first bytes (``bridge.load_jax_checkpoint``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch

from indoor_nerf_tpu_torch.train.optim import named_leaves

CKPT_SUFFIX = ".ckpt"
FORMAT = "indoor_nerf_tpu_torch.ckpt.v1"
_SCALARS = ("best_loss", "loss_ema", "loss_ema_slow", "infl_ema")
# torch.save writes a zip archive; a flax msgpack state starts with a map.
_ZIP_MAGIC = b"PK\x03\x04"


def _tensor_leaves(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Every tensor of a train state by its dotted path (views, no copies)."""
    out = {f"params.{k}": v for k, v in named_leaves(state["params"]).items()}
    for key in ("mu", "nu"):
        out.update({f"opt.{key}.{k}": v for k, v in state["opt"][key].items()})
    if state.get("occ") is not None:
        out["occ.density"] = state["occ"]["density"]
    if state.get("ema") is not None:
        out.update({f"ema.{k}": v for k, v in named_leaves(state["ema"]).items()})
    if state.get("quant") is not None:
        out.update({f"quant.{group}.{k}": v
                    for group, leaves in state["quant"].items()
                    for k, v in leaves.items()})
    out.update({k: state[k] for k in _SCALARS if k in state})
    return out


def _payload(state: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {"format": FORMAT}
    out.update({k: v.detach().cpu() for k, v in _tensor_leaves(state).items()})
    out["opt.step"] = int(state["opt"]["step"])
    out["step"] = int(state["step"])
    if "proposal_since" in state:
        out["proposal_since"] = int(state["proposal_since"])
    return out


def atomic_save(path: str, payload: Dict[str, Any]) -> str:
    """``torch.save`` to ``path + ".tmp"``, flushed and fsynced, then renamed:
    a run cut mid-save never leaves a truncated file under ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def save_checkpoint(logdir: str, step: int, state: Dict[str, Any]) -> str:
    """Write ``<logdir>/{step:06d}.ckpt`` atomically; returns its path."""
    os.makedirs(logdir, exist_ok=True)
    return atomic_save(os.path.join(logdir, f"{step:06d}{CKPT_SUFFIX}"),
                       _payload(state))


def save_best_checkpoint(logdir: str, state: Dict[str, Any]) -> str:
    """The best held-out snapshot as ``best.ckpt``, kept out of auto-resume
    (``list_checkpoints`` keeps step-numbered files); load it with
    ``--ft_path <logdir>/best.ckpt``. ``train`` writes it whenever a
    test set's mean PSNR is a new best."""
    os.makedirs(logdir, exist_ok=True)
    return atomic_save(os.path.join(logdir, f"best{CKPT_SUFFIX}"),
                       _payload(state))


def list_checkpoints(logdir: str) -> List[str]:
    """Sorted paths of the step-numbered checkpoints in ``logdir``."""
    if not os.path.isdir(logdir):
        return []
    return [
        os.path.join(logdir, f)
        for f in sorted(os.listdir(logdir))
        # best.ckpt would sort after the digits and hijack resume-newest
        if f.endswith(CKPT_SUFFIX) and f[: -len(CKPT_SUFFIX)].isdigit()
    ]


def _restore_own(payload: Dict[str, Any], template: Dict[str, Any],
                 path: str) -> Dict[str, Any]:
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path}: not a checkpoint of this package (format "
                         f"{payload.get('format')!r}, expected {FORMAT!r})")
    leaves = _tensor_leaves(template)
    ema = [k for k in leaves if k.startswith("ema.")]
    # A file without the EMA seeds it from the restored params (the JAX
    # rule, utils/checkpoint.py:75-93); a part of one is refused.
    seed_ema = bool(ema) and not any(k in payload for k in ema)
    required = [k for k in leaves if k.startswith("params.")
                or (k.startswith("ema.") and not seed_ema)]
    missing = [k for k in required if k not in payload]
    if missing:
        raise ValueError(f"{path}: no leaf {missing[0]!r}")
    # Trained state is never dropped: params, an EMA or quantizers (a file
    # without quantizers restores into a quantized state's fresh ones, as a
    # JAX checkpoint written before they existed would).
    extra = [k for k in payload if k.startswith(("params.", "ema.", "quant."))
             and k not in leaves]
    if extra:
        hint = ""
        if extra[0].startswith("quant."):
            hint = " (train and serve it with --use_quantization)"
        elif extra[0].endswith(".appearance"):
            hint = " (train and serve it with --use_appearance)"
        raise ValueError(f"{path}: leaf {extra[0]!r} has no place in the "
                         f"configuration's state; it would be dropped{hint}")
    with torch.no_grad():
        for name, t in leaves.items():
            if name not in payload:
                continue  # an optional key: the template's value stays
            src = payload[name]
            if tuple(src.shape) != tuple(t.shape) or src.dtype != t.dtype:
                raise ValueError(
                    f"{path}: leaf {name!r} is {src.dtype} "
                    f"{tuple(src.shape)}; the configuration builds {t.dtype} "
                    f"{tuple(t.shape)}")
            if name in _SCALARS:
                template[name] = src.to(t.device)
            elif name.startswith("quant."):
                _, group, key = name.split(".")
                template["quant"][group][key] = src.to(t.device)
            else:
                t.copy_(src)
        if seed_ema:
            for name in ema:
                leaves[name].copy_(leaves["params." + name[len("ema."):]])
    if "opt.step" in payload:
        template["opt"]["step"] = int(payload["opt.step"])
    if "step" in payload:
        template["step"] = int(payload["step"])
    if "proposal_since" in payload and "proposal_since" in template:
        template["proposal_since"] = int(payload["proposal_since"])
    return template


def restore_checkpoint(path: str, state_template: Dict[str, Any],
                       device=None) -> Dict[str, Any]:
    """Restore ``path`` into the template train state (its leaves are
    overwritten in place and it is returned); every leaf's shape and dtype
    must match the template's, else a ``ValueError`` names the leaf. A
    missing optional top-level key (the moments, the grid, the counters)
    keeps the template's value; a missing params EMA starts at the restored
    params, and an EMA the template has no place for is refused. ``device``
    defaults to the template's.

    A file written by the JAX package's ``save_checkpoint`` is imported
    through ``bridge.load_jax_checkpoint`` and ``bridge.state_from_numpy``
    and held to the same shape check."""
    if device is None:
        device = next(iter(named_leaves(state_template["params"]).values())).device
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == _ZIP_MAGIC:
        payload = torch.load(path, weights_only=True, map_location=device)
        return _restore_own(payload, state_template, path)
    from indoor_nerf_tpu_torch.bridge import load_jax_checkpoint, state_from_numpy

    imported = state_from_numpy(load_jax_checkpoint(path), "cpu")
    return _restore_own(_payload(imported), state_template, path)


def maybe_resume(logdir: str, state: Dict[str, Any],
                 ft_path: Optional[str] = None,
                 no_reload: bool = False) -> Dict[str, Any]:
    """Resume from ``ft_path`` if set (``"None"`` counts as unset), else
    from the newest step-numbered checkpoint of ``logdir``, unless
    ``no_reload``."""
    if ft_path is not None and ft_path != "None":
        ckpts = [ft_path]
    else:
        ckpts = list_checkpoints(logdir)
    print("Found ckpts", ckpts)
    if ckpts and not no_reload:
        path = ckpts[-1]
        print("Reloading from", path)
        state = restore_checkpoint(path, state)
        print("Resumed at step", int(state["step"]))
    return state
