"""The proposal-chain models' render: nerfacto (nerfstudio
``ProposalNetworkSampler`` and ``NerfactoModel.get_outputs``, Tancik et
al., SIGGRAPH 2023, arXiv:2302.04264) and Mip-NeRF 360 (google-research/
multinerf ``internal/models.py``, Barron et al., CVPR 2022,
arXiv:2111.12077), on one route.

    out = render_rays_proposal(params, rays_o, rays_d, near, far, config,
                               step, draws, update, camera_idx)

The model is ``config.chain`` (a ``ProposalChain``), which names what
differs: the spacing (``to_t``: edges in a normalized spacing to depths),
the first edges and the resampler (``first_edges``, ``resample``), each
proposal level's density (``proposal_density``), the field query
(``field``), the compositing weights' background rule (``weights``) and
the colour's (``composite``); in training which steps train the proposal
levels (``update_due``). The training side of a chain (its data term,
learning rate, optimizer group and gradient clip) is
``train/step.py::ChainTraining``. A ray gets ``samples[0]`` intervals of the first edges; proposal level i
weighs them and ``samples[i + 1]`` new intervals are drawn from its
weights; the last level's go to the field. The depth is ``sum_i w_i
t_i``, ``t_i`` the interval's midpoint depth.

- ``NerfactoChain``: unit directions, the piecewise spacing
  (``ops/intervals.py``), edges jittered in their strata, the annealed
  histogram sampler ``pdf_edges``; each sample the midpoint of its
  interval, contracted into [-2, 2]^3, through two proposal hash fields
  and the nerfacto field; no interval stretched; the colour ``sum_i w_i
  c_i + (1 - sum_i w_i) c_last``. The proposal fields run under autograd
  only on steps that update them (``update_due``): past ``UPDATE_WARMUP``
  steps one step in ``UPDATE_EVERY + 1``, every step of the first ten. The
  anneal exponent ``10 f / (9 f + 1)``, ``f = min(step / ANNEAL_ITERS,
  1)``, acts in training; an evaluation render (no ``step``) takes 1 and
  the mean appearance embedding.
- ``MipNeRF360Chain``: the camera rays ``o + t d`` as they come, the
  reciprocal spacing, level 0 resampled from one interval [0, 1] of
  weight 1, ``sample_intervals`` at every level; each interval a conical
  frustum's Gaussian contracted by its Jacobian (in float64) and
  featurised by the IPE (the ``ipe`` span, without autograd: no parameter
  reaches it), one
  proposal MLP for both levels and the NeRF MLP; the last interval
  opaque; the colour ``sum_i w_i c_i``. Every step updates every net.

Counters (program counters, read on the host; nothing waits for the
card): ``sample_counts()`` gives the samples each level evaluated
(``proposal_0``, ``proposal_1``, ``field``) and the proposal updates since
``reset_counts()``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from indoor_nerf_tpu_torch.models.field import (
    APPEARANCE_DIM,
    PROPOSAL_HIDDEN,
    FieldConfig,
    MipNeRF360Config,
    NerfactoConfig,
    init_mipnerf360_params,
    init_nerfacto_params,
    nerfacto_query,
    pixel_radius,
    proposal_density,
)
from indoor_nerf_tpu_torch.ops.constants import device_constant
from indoor_nerf_tpu_torch.ops.intervals import (
    conical_frustum,
    contract,
    contract_gaussian,
    initial_edges,
    integrated_pos_enc,
    interval_weights,
    pdf_edges,
    pos_enc,
    reciprocal_to_t,
    sample_intervals,
    x_to_t,
)
from indoor_nerf_tpu_torch.utils.spans import span

_LOCK = threading.Lock()
_counts: Dict[str, int] = {}


def sample_counts() -> Dict[str, int]:
    """Samples evaluated per level (``proposal_0``, ``proposal_1``,
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


class ProposalChain:
    """What a proposal-chain model names (the module docstring); one
    instance, over its ``config`` (sample counts ``proposal_samples`` and
    ``nerf_samples``), is ``RenderConfig.chain``. ``name`` is the model's
    flag. Edges are ``[N, S + 1]`` in the normalized spacing, depths ``t``
    the same in depth."""

    name = ""
    # Whether the batch's rays carry their training image (img_idx).
    uses_camera_idx = False

    @property
    def samples(self) -> Tuple[int, ...]:
        """Intervals a ray at each proposal level, then at the field."""
        return tuple(self.config.proposal_samples) + (self.config.nerf_samples,)

    @property
    def n_proposals(self) -> int:
        return len(self.samples) - 1

    def for_camera(self, K) -> "ProposalChain":
        """The chain for the rays of a camera of intrinsics ``K``."""
        return self

    def update_due(self, step: int, since: int) -> bool:
        """Whether step ``step`` trains the proposal levels, ``since``
        steps after they last did."""
        return True

    # Each model's own: its params, draws and memory, and the
    # render's steps in the order ``render_rays_proposal`` takes them.
    def init_params(self, generator: torch.Generator, field: FieldConfig,
                    device=None) -> Dict[str, Any]:
        raise NotImplementedError

    def draw_shapes(self, n_rays: int) -> Dict[str, tuple]:
        raise NotImplementedError

    def bytes_per_ray(self, field: FieldConfig) -> int:
        raise NotImplementedError

    def first_edges(self, n: int, draws, device) -> torch.Tensor:
        """Level 0's edges ``[n, samples[0] + 1]``."""
        raise NotImplementedError

    def to_t(self, edges, near, far) -> torch.Tensor:
        raise NotImplementedError

    def proposal_density(self, params, i: int, rays_o, rays_d, dirs, t,
                         field: FieldConfig) -> torch.Tensor:
        """Proposal level ``i``'s density of the intervals between depths
        ``t``."""
        raise NotImplementedError

    def weights(self, density, t, rays_d) -> torch.Tensor:
        """Compositing weights ``[N, S]``, with the model's background
        rule."""
        raise NotImplementedError

    def resample(self, edges, w, i: int, draws, step) -> torch.Tensor:
        """Level ``i + 1``'s edges from level ``i``'s weights."""
        raise NotImplementedError

    def field(self, params, rays_o, rays_d, dirs, t, camera_idx,
              field: FieldConfig):
        """(density ``[N, S]``, rgb ``[N, S, 3]``, midpoint depths ``[N,
        S]``) of the field level."""
        raise NotImplementedError

    def composite(self, w, rgb, acc) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class NerfactoChain(ProposalChain):
    """Nerfacto's chain over ``config`` (the module docstring)."""

    config: NerfactoConfig
    name = "nerfacto"
    uses_camera_idx = True

    def init_params(self, generator, field, device=None):
        return init_nerfacto_params(generator, field, self.config, device)

    def draw_shapes(self, n_rays: int) -> Dict[str, tuple]:
        """One jitter a ray for the initial edges, one a ray for each PDF
        round."""
        return {"t_rand": (n_rays, 1),
                "u": (n_rays, len(self.config.proposal_grids))}

    def update_due(self, step: int, since: int) -> bool:
        return update_due(step, since)

    def first_edges(self, n: int, draws, device) -> torch.Tensor:
        return initial_edges(n, self.config.proposal_samples[0],
                             draws.get("t_rand"), device)

    def to_t(self, edges, near, far) -> torch.Tensor:
        return x_to_t(edges, near, far)

    def _points(self, rays_o, dirs, t):
        """(contracted midpoints ``[N, S, 3]``, midpoint depths ``[N,
        S]``)."""
        mids = 0.5 * (t[:, 1:] + t[:, :-1])
        with span("contract"):
            pts = contract(rays_o[:, None, :] + dirs[:, None, :]
                           * mids[..., None])
        return pts, mids

    def proposal_density(self, params, i: int, rays_o, rays_d, dirs, t,
                         field: FieldConfig) -> torch.Tensor:
        pts, _ = self._points(rays_o, dirs, t)
        return proposal_density(params[f"proposal_{i}"], pts.reshape(-1, 3),
                                self.config.proposal_grids[i],
                                field.torch_compute_dtype)

    def weights(self, density, t, rays_d) -> torch.Tensor:
        return interval_weights(density.reshape(t.shape[0], -1),
                                t[:, 1:] - t[:, :-1])

    def resample(self, edges, w, i: int, draws, step) -> torch.Tensor:
        u = draws.get("u")
        return pdf_edges(edges, w, self.samples[i + 1],
                         None if u is None else u[:, i:i + 1], anneal(step))

    def field(self, params, rays_o, rays_d, dirs, t, camera_idx,
              field: FieldConfig):
        pts, mids = self._points(rays_o, dirs, t)
        n = rays_o.shape[0]
        table = params["embedding_appearance"]
        if camera_idx is None:
            emb = table.mean(dim=0, keepdim=True).expand(n, table.shape[-1])
        else:
            emb = table[camera_idx.long()]
        density, rgb = nerfacto_query(params, pts, dirs, emb, field)
        return density, rgb, mids

    def composite(self, w, rgb, acc) -> torch.Tensor:
        return torch.sum(w[..., None] * rgb, dim=-2) \
            + (1.0 - acc)[:, None] * rgb[:, -1, :]

    def bytes_per_ray(self, field: FieldConfig) -> int:
        """Each proposal pass's samples at its hash grid's encode bytes and
        its sigma net's, the field's at ``_sample_bytes`` and its
        appearance row, counted as if live together."""
        from indoor_nerf_tpu_torch.render.renderer import (
            SAMPLE_BYTES,
            _sample_bytes,
        )

        total = 0
        for g, n in zip(self.config.proposal_grids,
                        self.config.proposal_samples):
            total += n * (g.n_levels * (32 + 32 + 64 * g.n_features_per_level)
                          + 4 * (g.out_dim + 2 * PROPOSAL_HIDDEN)
                          + SAMPLE_BYTES)
        return total + self.config.nerf_samples * (
            _sample_bytes(field) + 4 * APPEARANCE_DIM)


@dataclasses.dataclass(frozen=True)
class MipNeRF360Chain(ProposalChain):
    """Mip-NeRF 360's chain over ``config`` (the module docstring)."""

    config: MipNeRF360Config
    name = "mipnerf360"

    def for_camera(self, K) -> "MipNeRF360Chain":
        """The chain at the base radius of ``K``'s pixels."""
        radius = pixel_radius(float(K[0][0]))
        if radius == self.config.pixel_radius:
            return self
        return dataclasses.replace(self, config=dataclasses.replace(
            self.config, pixel_radius=radius))

    def init_params(self, generator, field, device=None):
        return init_mipnerf360_params(generator, self.config, device)

    def draw_shapes(self, n_rays: int) -> Dict[str, tuple]:
        """One jitter a ray for each level's resampling."""
        return {"u": (n_rays, len(self.samples))}

    def _resample(self, edges, w, n: int, draws, k: int) -> torch.Tensor:
        u = draws.get("u")
        return sample_intervals(edges, w, n,
                                None if u is None else u[:, k:k + 1])

    def first_edges(self, n: int, draws, device) -> torch.Tensor:
        """Level 0's intervals, resampled from one interval [0, 1] of weight
        1 (the ``pdf`` span)."""
        whole = device_constant([[0.0, 1.0]], torch.float32, device)
        with span("pdf"):
            return self._resample(whole.expand(n, 2),
                                  torch.ones((n, 1), device=device),
                                  self.samples[0], draws, 0)

    def to_t(self, edges, near, far) -> torch.Tensor:
        return reciprocal_to_t(edges, near, far)

    def _features(self, rays_o, rays_d, t) -> torch.Tensor:
        """The IPE ``[N * S, 6 L]`` of the intervals between depths ``t``:
        frustum, Gaussian, contraction, encoding (the ``ipe`` span). The
        Gaussians and their contraction are computed in float64, the
        encoding in float32: in float32 the contracted covariance of a far
        interval (depths 0.4 to 1000) loses up to 1% of its least axis to
        cancellation, which the IPE's high degrees turn into ~4e-3 of a
        feature."""
        with span("ipe"), torch.no_grad():
            d = rays_d.double()
            mean, t_var, r_var = conical_frustum(
                rays_o.double(), d, t.double(), self.config.pixel_radius)
            mean, var = contract_gaussian(mean, d, t_var, r_var)
            feats = integrated_pos_enc(mean.float(), var.float(),
                                       self.config.ipe_degrees)
        return feats.reshape(-1, feats.shape[-1])

    def proposal_density(self, params, i: int, rays_o, rays_d, dirs, t,
                         field: FieldConfig) -> torch.Tensor:
        feats = self._features(rays_o, rays_d, t)
        with span("mlp"):
            density, _ = params["proposal_mlp"](feats)
        return density

    def weights(self, density, t, rays_d) -> torch.Tensor:
        deltas = (t[:, 1:] - t[:, :-1]) * torch.linalg.norm(
            rays_d, dim=-1, keepdim=True)
        return interval_weights(density.reshape(t.shape[0], -1), deltas,
                                opaque_last=True)

    def resample(self, edges, w, i: int, draws, step) -> torch.Tensor:
        return self._resample(edges, w, self.samples[i + 1], draws, i + 1)

    def field(self, params, rays_o, rays_d, dirs, t, camera_idx,
              field: FieldConfig):
        n, s = t.shape[0], t.shape[1] - 1
        feats = self._features(rays_o, rays_d, t)
        views = pos_enc(dirs, self.config.view_degrees)
        views = views[:, None, :].expand(n, s, views.shape[-1])
        with span("mlp"):
            density, rgb = params["nerf_mlp"](feats,
                                              views.reshape(n * s, -1))
        return (density.reshape(n, s), rgb.reshape(n, s, 3),
                0.5 * (t[:, 1:] + t[:, :-1]))

    def composite(self, w, rgb, acc) -> torch.Tensor:
        return torch.sum(w[..., None] * rgb, dim=-2)

    def bytes_per_ray(self, field: FieldConfig) -> int:
        """Test mode, each level's samples counted as if live together: the
        IPE's temporaries (~16 planes of its 6 L features), the widest
        layer's input and output and the compositing tensors a sample."""
        from indoor_nerf_tpu_torch.render.renderer import SAMPLE_BYTES

        c = self.config
        total = 0
        for n, width in ((c.proposal_samples[0], c.prop_netwidth),
                         (c.proposal_samples[-1], c.prop_netwidth),
                         (c.nerf_samples, c.netwidth)):
            total += n * (16 * 4 * c.input_ch + 4 * 3 * (width + c.input_ch)
                          + SAMPLE_BYTES)
        return total


def render_rays_proposal(params: Dict[str, Any], rays_o: torch.Tensor,
                         rays_d: torch.Tensor, near: torch.Tensor,
                         far: torch.Tensor, config, step: Optional[int],
                         draws: Dict[str, torch.Tensor], update: bool,
                         camera_idx: Optional[torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
    """Render ``[N]`` rays (``near``, ``far`` ``[N, 1]``) through the chain
    ``config.chain`` (``config``: a ``RenderConfig``). Returns the maps
    (``rgb_map``, ``depth_map``, ``acc_map``, ``disp_map``), the field's
    ``weights`` ``[N, S]``, ``edges`` ``[N, S + 1]`` (normalized spacing)
    and ``z_vals`` (midpoint depths), and the proposal levels'
    ``proposal_edges`` and ``proposal_weights`` (lists), which the
    interlevel loss reads. ``update``: the proposal levels run under
    autograd. ``camera_idx`` ``[N]``: the rays' rows of nerfacto's
    appearance embedding (None: its mean)."""
    chain: ProposalChain = config.chain
    fc = config.field
    n = rays_o.shape[0]
    dirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    edges = chain.first_edges(n, draws, rays_o.device)
    edges_list, weights_list = [], []
    with span("proposal"):
        for i in range(chain.n_proposals):
            t = chain.to_t(edges, near, far)
            with torch.set_grad_enabled(update and torch.is_grad_enabled()):
                density = chain.proposal_density(params, i, rays_o, rays_d,
                                                 dirs, t, fc)
                w = chain.weights(density, t, rays_d)
            _count(f"proposal_{i}", n * (t.shape[1] - 1))
            edges_list.append(edges)
            weights_list.append(w)
            with span("pdf"):
                edges = chain.resample(edges, w, i, draws, step)
    t = chain.to_t(edges, near, far)
    density, rgb, mids = chain.field(params, rays_o, rays_d, dirs, t,
                                     camera_idx, fc)
    _count("field", n * mids.shape[1])
    with span("composite"):
        w = chain.weights(density, t, rays_d)
        acc = w.sum(dim=-1)
        rgb_map = chain.composite(w, rgb, acc)
        depth = torch.sum(w * mids, dim=-1)
    return {"rgb_map": rgb_map, "depth_map": depth, "acc_map": acc,
            "disp_map": 1.0 / torch.clamp_min(depth, 1e-10), "weights": w,
            "edges": edges, "z_vals": mids, "proposal_edges": edges_list,
            "proposal_weights": weights_list}
