"""Small constant tensors of the hot paths, copied to a device once.

A tensor built from host data on the card (``torch.tensor(values,
device=...)``) is a copy from pageable host memory, which waits for all the
work queued on the card: the host stalls and the device then idles while
the host queues the rest of the step. The bounding box, the level
resolutions and the like are therefore made once per (values, dtype,
device) and shared. The tensors are read-only by convention: no caller
modifies them in place.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _frozen(values):
    """Nested tuples of Python numbers (hashable) from an array or a
    sequence."""
    if isinstance(values, np.ndarray):
        values = values.tolist()
    if isinstance(values, (list, tuple)):
        return tuple(_frozen(v) for v in values)
    return values


@functools.lru_cache(maxsize=256)
def _make(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # Made outside inference mode even when the first caller is a render:
    # an inference tensor could not be saved for a later step's backward.
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once and
    shared by every later call with equal arguments."""
    return _make(_frozen(values), dtype, torch.device(device))
