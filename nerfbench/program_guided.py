"""The guided baked server as the benchmark builds it: ``serve.build`` with
``--baked`` and ``--guided`` (the snapshot baked at start-up, no snapshot
file; each request a coarse pass at 1/``guided`` of the resolution that
bounds every ray's depth window, then 16 samples a ray inside it), the
rest of ``serve.py``'s defaults."""

from __future__ import annotations

import argparse
from typing import List


def serve_build(flags: List[str], width: int, height: int, baked_res: int,
                guided: int):
    """``serve.build`` of the guided baked server at ``width`` x
    ``height``: returns ``(render, step, (H, W))``; the bake and one
    warm-up render run inside."""
    from indoor_nerf_tpu_torch import serve

    return serve.build(argparse.Namespace(
        width=width, height=height, baked=True, baked_res=baked_res,
        baked_geo_res=-1, baked_dtype="bfloat16", guided=guided,
        snapshot=None, train_args=["--"] + flags))
