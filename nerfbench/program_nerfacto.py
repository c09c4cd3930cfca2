"""The program's nerfacto counters, as the benchmark reads them: the samples
each field evaluated and the proposal updates (``render/proposal.py``'s
``sample_counts``)."""

from __future__ import annotations

from typing import Dict

from indoor_nerf_tpu_torch.render import proposal


def reset_counts() -> None:
    proposal.reset_counts()


def sample_counts() -> Dict[str, int]:
    return proposal.sample_counts()
