"""Nerfacto's render: the proposal sampling chain and interval compositing
(nerfstudio ``ProposalNetworkSampler`` and ``NerfactoModel.get_outputs``,
Tancik et al., SIGGRAPH 2023, arXiv:2302.04264).

    out = render_rays_proposal(params, rays_o, rays_d, near, far, config,
                               step, draws, update, camera_idx)

A ray (its direction made unit) gets ``proposal_samples[0]`` intervals
spaced uniformly in the piecewise spacing (``ops/intervals.py``); proposal
field 0 weighs them, ``proposal_samples[1]`` new intervals are drawn from
its (annealed) weights, proposal field 1 weighs those, and
``nerf_samples`` intervals drawn from its weights go to the field. Every
sample is the midpoint of its interval, contracted into [-2, 2]^3. The
colour is ``sum_i w_i c_i + (1 - sum_i w_i) c_last`` (the last sample's
colour is the background), the depth ``sum_i w_i t_i``.

Proposal fields run under autograd only on steps that update them
(``update``; ``update_due``): past ``UPDATE_WARMUP`` steps one step in
``UPDATE_EVERY + 1``, every step of the first ten. The weights' anneal
exponent ``10 f / (9 f + 1)``, ``f = min(step / ANNEAL_ITERS, 1)``, acts in
training; an evaluation render (no ``step``) takes 1 and the mean
appearance embedding.

Counters (program counters, read on the host; nothing waits for the
card): ``sample_counts()`` gives the samples each field evaluated and the
proposal updates since ``reset_counts()``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from indoor_nerf_tpu_torch.models.field import (
    NerfactoConfig,
    nerfacto_query,
    proposal_density,
)
from indoor_nerf_tpu_torch.ops.intervals import (
    contract,
    initial_edges,
    interval_weights,
    pdf_edges,
    x_to_t,
)
from indoor_nerf_tpu_torch.utils.spans import span

_LOCK = threading.Lock()
_counts: Dict[str, int] = {}


def sample_counts() -> Dict[str, int]:
    """Samples evaluated per field (``proposal_0``, ``proposal_1``,
    ``field``) and proposal updates (``updates``) since the last
    ``reset_counts``."""
    with _LOCK:
        return dict(_counts)


def reset_counts() -> None:
    with _LOCK:
        _counts.clear()


def _count(name: str, n: int) -> None:
    with _LOCK:
        _counts[name] = _counts.get(name, 0) + int(n)


def count_update() -> None:
    """One step that updated the proposal fields (``train/step.py``)."""
    _count("updates", 1)


# nerfstudio's schedule: the anneal's length, and the update interval
# reached after the warm-up.
ANNEAL_ITERS = 1000
UPDATE_EVERY, UPDATE_WARMUP = 5, 5000


def anneal(step: Optional[int]) -> float:
    """The weights' exponent at training step ``step`` (1 in evaluation)."""
    if step is None:
        return 1.0
    f = min(step / ANNEAL_ITERS, 1.0)
    return 10.0 * f / (9.0 * f + 1.0)


def update_due(step: int, since: int) -> bool:
    """Whether step ``step`` updates the proposal fields, ``since`` steps
    after the last update: ``since`` above ``clip(interp(step, [0,
    UPDATE_WARMUP], [0, UPDATE_EVERY]), 1, UPDATE_EVERY)``, or a step of
    the first ten."""
    sched = float(np.clip(np.interp(step, [0, UPDATE_WARMUP],
                                    [0, UPDATE_EVERY]), 1, UPDATE_EVERY))
    return since > sched or step < 10


def draw_shapes(nc: NerfactoConfig, n_rays: int) -> Dict[str, tuple]:
    """A training render's draws: one jitter a ray for the initial edges,
    one a ray for each PDF round."""
    return {"t_rand": (n_rays, 1), "u": (n_rays, len(nc.proposal_grids))}


def _points(rays_o, dirs, t):
    """(contracted midpoints ``[N, S, 3]``, midpoint depths ``[N, S]``) of
    the intervals between depths ``t`` ``[N, S + 1]``."""
    mids = 0.5 * (t[:, 1:] + t[:, :-1])
    with span("contract"):
        pts = contract(rays_o[:, None, :] + dirs[:, None, :] * mids[..., None])
    return pts, mids


def render_rays_proposal(params: Dict[str, Any], rays_o: torch.Tensor,
                         rays_d: torch.Tensor, near: torch.Tensor,
                         far: torch.Tensor, config, step: Optional[int],
                         draws: Dict[str, torch.Tensor], update: bool,
                         camera_idx: Optional[torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
    """Render ``[N]`` rays (``near``, ``far`` ``[N, 1]``) through the chain
    of ``config.nerfacto`` (``config``: a ``RenderConfig``). Returns the maps
    (``rgb_map``, ``depth_map``, ``acc_map``, ``disp_map``), the field's
    ``weights`` ``[N, S]``, ``edges`` ``[N, S + 1]`` (normalized spacing)
    and ``z_vals`` (midpoint depths), and the proposal levels'
    ``proposal_edges`` and ``proposal_weights`` (lists), which the
    interlevel loss reads. ``camera_idx`` ``[N]``: the rays' rows of the
    appearance embedding (None: its mean)."""
    nc: NerfactoConfig = config.nerfacto
    fc = config.field
    n = rays_o.shape[0]
    dirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    u = draws.get("u")
    ann = anneal(step)
    dtype = fc.torch_compute_dtype
    edges = initial_edges(n, nc.proposal_samples[0], draws.get("t_rand"),
                          rays_o.device)
    edges_list, weights_list = [], []
    n_next = list(nc.proposal_samples[1:]) + [nc.nerf_samples]
    with span("proposal"):
        for i, grid in enumerate(nc.proposal_grids):
            t = x_to_t(edges, near, far)
            pts, _ = _points(rays_o, dirs, t)
            with torch.set_grad_enabled(update and torch.is_grad_enabled()):
                density = proposal_density(params[f"proposal_{i}"],
                                           pts.reshape(-1, 3), grid, dtype)
                w = interval_weights(density.reshape(n, -1),
                                     t[:, 1:] - t[:, :-1])
            _count(f"proposal_{i}", pts.shape[0] * pts.shape[1])
            edges_list.append(edges)
            weights_list.append(w)
            with span("pdf"):
                edges = pdf_edges(edges, w, n_next[i],
                                  None if u is None else u[:, i:i + 1], ann)
    t = x_to_t(edges, near, far)
    pts, mids = _points(rays_o, dirs, t)
    table = params["embedding_appearance"]
    if camera_idx is None:
        emb = table.mean(dim=0, keepdim=True).expand(n, table.shape[-1])
    else:
        emb = table[camera_idx.long()]
    density, rgb = nerfacto_query(params, pts, dirs, emb, fc)
    _count("field", pts.shape[0] * pts.shape[1])
    with span("composite"):
        w = interval_weights(density, t[:, 1:] - t[:, :-1])
        acc = w.sum(dim=-1)
        rgb_map = torch.sum(w[..., None] * rgb, dim=-2) \
            + (1.0 - acc)[:, None] * rgb[:, -1, :]
        depth = torch.sum(w * mids, dim=-1)
    return {"rgb_map": rgb_map, "depth_map": depth, "acc_map": acc,
            "disp_map": 1.0 / torch.clamp_min(depth, 1e-10), "weights": w,
            "edges": edges, "z_vals": mids, "proposal_edges": edges_list,
            "proposal_weights": weights_list}
