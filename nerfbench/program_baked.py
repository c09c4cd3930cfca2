"""The baked server as the benchmark builds it: ``serve.build`` with
``--baked`` (the snapshot baked at start-up, no snapshot file, the
uniform 128-sample march), the rest of ``serve.py``'s defaults."""

from __future__ import annotations

import argparse
from typing import List


def serve_build(flags: List[str], width: int, height: int, baked_res: int):
    """``serve.build`` of the baked server at ``width`` x ``height``:
    returns ``(render, step, (H, W))``; the bake and one warm-up render
    run inside."""
    from indoor_nerf_tpu_torch import serve

    return serve.build(argparse.Namespace(
        width=width, height=height, baked=True, baked_res=baked_res,
        baked_geo_res=-1, baked_dtype="bfloat16", guided=0, snapshot=None,
        train_args=["--"] + flags))
