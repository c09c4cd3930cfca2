"""The CLI parser and ``FLAGSHIP_PRESET``, loaded from the JAX package's file.

``indoor_nerf_tpu/train/config.py`` imports only argparse, but importing it
as ``indoor_nerf_tpu.train.config`` runs ``indoor_nerf_tpu/train/__init__.py``,
which imports jax (through ``train/optim.py``). So the file is loaded by
path: the port and the JAX package keep one parser and one flagship preset.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

_PATH = (Path(__file__).resolve().parents[2]
         / "indoor_nerf_tpu" / "train" / "config.py")


def _load():
    spec = importlib.util.spec_from_file_location(
        "indoor_nerf_tpu_torch.train._shared_config", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_config = _load()
build_parser = _config.build_parser
parse_args = _config.parse_args
FLAGSHIP_PRESET = _config.FLAGSHIP_PRESET
