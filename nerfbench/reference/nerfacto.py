"""Nerfacto in plain PyTorch float32 (TF32 off): its fields, its proposal
chain, its losses, a training step and an evaluation render, written from
the published description (nerfstudio's ``nerfacto`` method, Tancik et
al., SIGGRAPH 2023, arXiv:2302.04264; the proposal sampler and losses of
Mip-NeRF 360, Barron et al., CVPR 2022, arXiv:2111.12077) and the
configuration's values. It imports nothing of the program under test.

The equations:

- contraction: ``x`` where ``|x|_inf <= 1``, else ``(2 - 1/|x|_inf) x /
  |x|_inf``; a point outside (-2, 2)^3 has density 0;
- spacing: ``s(t) = t/2`` (t < 1), ``1 - 1/(2t)`` beyond; edges uniform in
  [s(near), s(far)]; samples at the intervals' midpoints in t; unit
  directions;
- weights: ``alpha_i = 1 - exp(-sigma_i delta_i)`` times the product of
  ``1 - alpha_j`` before it; rgb ``sum w c + (1 - sum w) c_last``; depth
  ``sum w t_mid``;
- the PDF sampler: ``w^anneal + 0.01``, padded to a total of 1e-5, the
  CDF capped at 1, draws ``k/(n+1)`` plus ``U[0,1)/(n+1)`` a ray (or
  ``1/(2(n+1))`` in evaluation), ``searchsorted(right)``, linear
  interpolation, clamped, NaN to 0, detached; anneal ``10f/(9f+1)``, ``f =
  min(step/1000, 1)``;
- updates: the proposal fields train on a step when the steps since their
  last update exceed ``clip(interp(step, [0, 5000], [0, 5]), 1, 5)`` or
  when ``step < 10``; the counter resets on an update and grows by one
  after each step; on other steps their parameters and moments stay;
- interlevel loss: per proposal level, the mean over rays and field
  intervals of ``max(0, w_i - W_i)^2 / (w_i + 1e-7)``, ``W_i`` the
  proposal's weight over the intervals overlapping field interval i (from
  cumulative sums and ``searchsorted``); the field's edges and weights
  detached;
- distortion: ``sum_ij w_i w_j |m_i - m_j| + 1/3 sum_i w_i^2 (e_{i+1} -
  e_i)`` on the field's intervals, the mean over rays;
- density ``trunc_exp`` (exp; its gradient multiplies by ``exp(min(x,
  15))``); the colour net reads ``[SH(d), geo, appearance]``, sigmoid out;
- the loss: MSE + 1.0 x interlevel + 0.002 x distortion; the optimizer:
  RAdam (``step.py``'s rectifier and learning rate) at eps 1e-15 and no
  weight decay on every leaf.

Departures from that description, each as the program shares it:

1. The initial edges' jitter is nerfstudio's ``SpacedSampler`` with one
   draw a ray: each edge moves within its stratum (interior edges by
   ``(u - 1/2)/n``, the two end edges by half as much toward the inside),
   where the description shifts every edge by ``u/n``.
2. The PDF sampler, the interlevel loss and the distortion read the edges
   in nerfstudio's normalized spacing, the affine image of [s(near),
   s(far)] onto [0, 1]; the distortion is ``1/(s(far) - s(near))`` times
   the one in s (1.026 at near 0.05, far 1000). Transmittance is
   ``exp(-cumsum(sigma delta))``, the product's value.
3. An evaluation render takes the anneal exponent 1 (nerfstudio's value
   before any training step, and after 1000) and the mean appearance
   embedding.
4. The hash grids are the program's hash-grid arithmetic (``grid.py``, the
   Instant-NGP hash with primes (1, 2654435761, 805459861) at every level,
   resolutions ``floor(16 b^l)``) on the box [-2, 2]^3; tcnn indexes the
   coarse levels densely where they fit the table. A point is clamped to
   the box before the encode and its density zeroed outside it (nerfstudio
   zeroes the point; the density is zero either way).
5. The direction's SH is taken of the unit direction (tcnn maps
   ``(d + 1)/2`` back to ``d``); the density has no ``average_init_density``
   factor (1 in nerfstudio's defaults).
6. One step counter for RAdam's rectifier, where torch's optimizers count
   each parameter's own steps: a proposal leaf skipped on a step still sees
   the shared counter advance.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nerfbench.reference import grid, model
from nerfbench.reference.step import BETA1, BETA2, lr_at, rectified

BOX = ((-2.0, -2.0, -2.0), (2.0, 2.0, 2.0))
Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """One hash grid on the contracted box, as ``grid.py`` reads it."""

    n_levels: int
    n_features: int
    log2_rows: int
    finest_res: int
    base_res: int = 16
    bbox_min: Tuple[float, float, float] = BOX[0]
    bbox_max: Tuple[float, float, float] = BOX[1]
    grid: str = "hash"

    @property
    def rows(self) -> int:
        return 1 << self.log2_rows

    @property
    def table_shape(self) -> Tuple[int, int]:
        return (self.n_levels * self.rows, self.n_features)


@dataclasses.dataclass(frozen=True)
class Spec:
    field: GridSpec
    proposals: Tuple[GridSpec, ...]
    proposal_samples: Tuple[int, ...]
    nerf_samples: int
    near: float
    far: float
    n_rand: int
    lrate: float
    lrate_decay: int
    interlevel_w: float
    distortion_w: float
    n_images: int
    embed_dim: int = 32
    hidden: int = 64
    geo: int = 15
    proposal_hidden: int = 16
    update_every: int = 5
    warmup: int = 5000
    anneal_iters: int = 1000
    # The control: every matrix product's operands rounded to TF32.
    tf32: bool = False
    # The operands of the MLPs rounded to bfloat16 (a test's variant).
    bf16: bool = False

    @property
    def samples_per_ray(self) -> Tuple[int, ...]:
        return tuple(self.proposal_samples) + (self.nerf_samples,)


def _ints(v) -> Tuple[int, ...]:
    return tuple(int(x) for x in str(v).split(","))


def make_spec(args: Dict, n_images: int) -> Spec:
    """The reference's settings from a nerfacto configuration's flags
    (nerfstudio's defaults where a flag is left out) and the number of
    training images."""
    a = {"n_levels": 16, "feats_per_level": 2, "log2_hashmap_size": 19,
         "finest_res": 2048, "proposal_levels": 5,
         "proposal_log2_hashmap_size": 17, "proposal_finest_res": "128,256",
         "proposal_samples": "256,96", "nerf_samples": 48,
         "near_plane": 0.05, "far_plane": 1000.0, "N_rand": 4096,
         "lrate": 1e-2, "lrate_decay": 100, "interlevel_loss_weight": 1.0,
         "distortion_loss_weight": 0.002, "appearance_embed_dim": 32,
         "proposal_hidden": 16, "proposal_update_every": 5,
         "proposal_warmup": 5000, "proposal_anneal_iters": 1000}
    a.update(args)
    proposals = tuple(
        GridSpec(int(a["proposal_levels"]), 2,
                 int(a["proposal_log2_hashmap_size"]), f)
        for f in _ints(a["proposal_finest_res"]))
    return Spec(
        field=GridSpec(int(a["n_levels"]), int(a["feats_per_level"]),
                       int(a["log2_hashmap_size"]), int(a["finest_res"])),
        proposals=proposals, proposal_samples=_ints(a["proposal_samples"]),
        nerf_samples=int(a["nerf_samples"]), near=float(a["near_plane"]),
        far=float(a["far_plane"]), n_rand=int(a["N_rand"]),
        lrate=float(a["lrate"]), lrate_decay=int(a["lrate_decay"]),
        interlevel_w=float(a["interlevel_loss_weight"]),
        distortion_w=float(a["distortion_loss_weight"]), n_images=n_images,
        embed_dim=int(a["appearance_embed_dim"]),
        proposal_hidden=int(a["proposal_hidden"]),
        update_every=int(a["proposal_update_every"]),
        warmup=int(a["proposal_warmup"]),
        anneal_iters=int(a["proposal_anneal_iters"]))


def layer_shapes(spec: Spec) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every leaf, by the program's checkpoint names: the three tables
    first, then the layers ``[in, out]``, then the embedding."""
    f = spec.field
    out = [("table", f.table_shape)]
    out += [(f"proposal_{i}.table", g.table_shape)
            for i, g in enumerate(spec.proposals)]
    h = spec.hidden
    out += [("coarse.sigma_net.0.w", (f.n_levels * f.n_features, h)),
            ("coarse.sigma_net.1.w", (h, 1 + spec.geo)),
            ("coarse.color_net.0.w", (16 + spec.geo + spec.embed_dim, h)),
            ("coarse.color_net.1.w", (h, h)),
            ("coarse.color_net.2.w", (h, 3))]
    for i, g in enumerate(spec.proposals):
        out += [(f"proposal_{i}.sigma_net.0.w",
                 (g.n_levels * g.n_features, spec.proposal_hidden)),
                (f"proposal_{i}.sigma_net.1.w", (spec.proposal_hidden, 1))]
    out.append(("embedding_appearance", (spec.n_images, spec.embed_dim)))
    return out


def make_params(spec: Spec, seed: int, device, table_scale: float) -> Params:
    """The benchmark's weights from ``seed``: one generator on ``device``;
    each table U(-table_scale, table_scale) in turn, one uniform draw for
    every layer, each U(-1/sqrt(fan_in), 1/sqrt(fan_in)), and the
    embedding N(0, 1)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    shapes = layer_shapes(spec)
    params: Params = {}
    for name, shape in shapes:
        if name.endswith("table"):
            t = torch.rand(shape, generator=gen, device=device)
            params[name] = t.mul_(2 * table_scale).sub_(table_scale)
    layers = [(n, s) for n, s in shapes if n.endswith(".w")]
    sizes = [int(np.prod(s)) for _, s in layers]
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    off = 0
    for (name, shape), n in zip(layers, sizes):
        bound = 1.0 / float(shape[0]) ** 0.5
        params[name] = (flat[off:off + n] * (2 * bound) - bound).view(shape)
        off += n
    e_shape = dict(shapes)["embedding_appearance"]
    params["embedding_appearance"] = torch.randn(e_shape, generator=gen,
                                                 device=device)
    return {name: params[name] for name, _ in shapes}


# ---- the fields ----

class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, max=15.0))


def _mm(a: torch.Tensor, b: torch.Tensor, spec: Spec) -> torch.Tensor:
    if spec.tf32:
        a, b = model._RoundTF32.apply(a), model._RoundTF32.apply(b)
    elif spec.bf16:
        a, b = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    return a @ b


def contract(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, ord=float("inf"), dim=-1, keepdim=True)
    inside = n <= 1.0
    n = torch.where(inside, torch.ones_like(n), n)
    return torch.where(inside, x, (2.0 - 1.0 / n) * (x / n))


def proposal_density(params: Params, i: int, x: torch.Tensor,
                     spec: Spec) -> torch.Tensor:
    """Proposal field ``i``'s density ``[N]`` at contracted points."""
    p = lambda k: params[f"proposal_{i}.{k}"]  # noqa: E731
    feats, keep = grid.hash_encode(x, p("table"), spec.proposals[i])
    h = _mm(torch.relu(_mm(feats, p("sigma_net.0.w"), spec)),
            p("sigma_net.1.w"), spec)
    return torch.where(keep, _TruncExp.apply(h[:, 0]), 0.0)


def field(params: Params, x: torch.Tensor, dirs: torch.Tensor,
          emb: torch.Tensor, spec: Spec):
    """(density ``[N]``, rgb ``[N, 3]``) of the field at contracted points
    ``x``, unit directions ``dirs`` and embedding rows ``emb``, ``[N, .]``
    each."""
    p = lambda k: params[f"coarse.{k}"]  # noqa: E731
    feats, keep = grid.hash_encode(x, params["table"], spec.field)
    h = _mm(torch.relu(_mm(feats, p("sigma_net.0.w"), spec)),
            p("sigma_net.1.w"), spec)
    sigma = torch.where(keep, _TruncExp.apply(h[:, 0]), 0.0)
    c = torch.cat([model.sh_encode(dirs), h[:, 1:], emb], dim=-1)
    c = torch.relu(_mm(c, p("color_net.0.w"), spec))
    c = torch.relu(_mm(c, p("color_net.1.w"), spec))
    return sigma, torch.sigmoid(_mm(c, p("color_net.2.w"), spec))


# ---- the chain ----

def s_of(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t < 1.0, 0.5 * t, 1.0 - 0.5 / t)


def t_of(s: torch.Tensor) -> torch.Tensor:
    return torch.where(s < 0.5, 2.0 * s, 1.0 / (2.0 - 2.0 * s))


def depths(x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """Depths of normalized spacings ``x``."""
    s0 = s_of(torch.tensor(spec.near, dtype=torch.float32))
    s1 = s_of(torch.tensor(spec.far, dtype=torch.float32))
    return t_of(x * s1 + (1.0 - x) * s0)


def first_edges(n_rays: int, n: int, u: Optional[torch.Tensor], device):
    e = torch.linspace(0.0, 1.0, n + 1, device=device).expand(n_rays, n + 1)
    if u is None:
        return e
    mid = 0.5 * (e[:, 1:] + e[:, :-1])
    lo = torch.cat([e[:, :1], mid], dim=1)
    hi = torch.cat([mid, e[:, -1:]], dim=1)
    return lo + (hi - lo) * u


def weights_of(sigma: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    tau = sigma * delta
    alpha = 1.0 - torch.exp(-tau)
    before = torch.cat([torch.zeros_like(tau[:, :1]),
                        torch.cumsum(tau[:, :-1], dim=1)], dim=1)
    return torch.nan_to_num(alpha * torch.exp(-before))


def pdf(edges: torch.Tensor, w: torch.Tensor, n: int,
        u: Optional[torch.Tensor], anneal: float) -> torch.Tensor:
    """``n + 1`` new edges from the histogram ``w`` over ``edges``."""
    w = w.detach()
    if anneal != 1.0:
        w = w ** anneal
    w = w + 0.01
    tot = w.sum(dim=1, keepdim=True)
    pad = torch.clamp(1e-5 - tot, min=0.0)
    w = w + pad / w.shape[1]
    cdf = torch.clamp(torch.cumsum(w / (tot + pad), dim=1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=1)
    m = n + 1
    k = torch.linspace(0.0, 1.0 - 1.0 / m, m, device=w.device)[None, :]
    draws = k + (u / m if u is not None else 1.0 / (2 * m))
    draws = draws.expand(w.shape[0], m).contiguous()
    e = edges.detach()
    j = torch.searchsorted(cdf, draws, right=True)
    lo = torch.clamp(j - 1, 0, e.shape[1] - 1)
    hi = torch.clamp(j, 0, e.shape[1] - 1)
    c0, c1 = cdf.gather(1, lo), cdf.gather(1, hi)
    e0, e1 = e.gather(1, lo), e.gather(1, hi)
    f = torch.clamp(torch.nan_to_num((draws - c0) / (c1 - c0), 0.0), 0.0, 1.0)
    return e0 + f * (e1 - e0)


def anneal_at(spec: Spec, step: Optional[int]) -> float:
    if step is None:
        return 1.0
    f = min(step / spec.anneal_iters, 1.0)
    return 10.0 * f / (9.0 * f + 1.0)


def update_due(spec: Spec, step: int, since: int) -> bool:
    sched = min(max(spec.update_every * min(step / spec.warmup, 1.0), 1.0),
                spec.update_every)
    return since > sched or step < 10


def render_rays(params: Params, rays_o: torch.Tensor, rays_d: torch.Tensor,
                spec: Spec, step: Optional[int] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None,
                update: bool = False,
                camera_idx: Optional[torch.Tensor] = None) -> Dict:
    """Render ``[N]`` rays: training with ``draws`` (``t_rand`` ``[N, 1]``,
    ``u`` ``[N, 2]``) and ``step``, or evaluation without. The proposal
    fields run under autograd when ``update``. ``points``: the contracted
    points each field queried, ``[N * S, 3]`` a field, the proposals'
    first."""
    draws = draws or {}
    n = rays_o.shape[0]
    dirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    u = draws.get("u")
    ann = anneal_at(spec, step)
    edges = first_edges(n, spec.proposal_samples[0], draws.get("t_rand"),
                        rays_o.device)
    prop_edges, prop_w, prop_pts = [], [], []
    for i in range(len(spec.proposals)):
        t = depths(edges, spec)
        mid = 0.5 * (t[:, 1:] + t[:, :-1])
        pts = contract(rays_o[:, None] + dirs[:, None] * mid[..., None])
        prop_pts.append(pts.reshape(-1, 3))
        with torch.set_grad_enabled(update and torch.is_grad_enabled()):
            sig = proposal_density(params, i, pts.reshape(-1, 3), spec)
            w = weights_of(sig.reshape(n, -1), t[:, 1:] - t[:, :-1])
        prop_edges.append(edges)
        prop_w.append(w)
        edges = pdf(edges, w, spec.samples_per_ray[i + 1],
                    None if u is None else u[:, i:i + 1], ann)
    t = depths(edges, spec)
    mid = 0.5 * (t[:, 1:] + t[:, :-1])
    pts = contract(rays_o[:, None] + dirs[:, None] * mid[..., None])
    table = params["embedding_appearance"]
    emb = (table.mean(dim=0, keepdim=True).expand(n, -1) if camera_idx is None
           else table[camera_idx.long()])
    s = mid.shape[1]
    sig, rgb = field(params, pts.reshape(-1, 3),
                     dirs[:, None].expand(n, s, 3).reshape(-1, 3),
                     emb[:, None].expand(n, s, emb.shape[-1]).reshape(n * s, -1),
                     spec)
    sig, rgb = sig.reshape(n, s), rgb.reshape(n, s, 3)
    w = weights_of(sig, t[:, 1:] - t[:, :-1])
    acc = w.sum(dim=1)
    return {"rgb": (w[..., None] * rgb).sum(dim=1)
            + (1.0 - acc)[:, None] * rgb[:, -1],
            "depth": (w * mid).sum(dim=1), "acc": acc, "weights": w,
            "edges": edges, "proposal_edges": prop_edges,
            "proposal_weights": prop_w,
            "points": prop_pts + [pts.reshape(-1, 3)]}


# ---- the losses ----

def interlevel(edges: torch.Tensor, w: torch.Tensor,
               prop_edges: Sequence[torch.Tensor],
               prop_w: Sequence[torch.Tensor]) -> torch.Tensor:
    c, w = edges.detach(), w.detach()
    total = torch.zeros((), device=w.device)
    for cp, wp in zip(prop_edges, prop_w):
        cum = torch.cat([torch.zeros_like(wp[:, :1]), wp.cumsum(dim=1)], dim=1)
        last = wp.shape[1] - 1
        lo = torch.clamp(torch.searchsorted(cp[:, :-1].contiguous(),
                                            c[:, :-1].contiguous(),
                                            right=True) - 1, 0, last)
        hi = torch.clamp(torch.searchsorted(cp[:, 1:].contiguous(),
                                            c[:, 1:].contiguous(),
                                            right=True), 0, last)
        bound = cum[:, 1:].gather(1, hi) - cum[:, :-1].gather(1, lo)
        total = total + (torch.clamp(w - bound, min=0.0) ** 2
                         / (w + 1e-7)).mean()
    return total


def distortion(edges: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    m = 0.5 * (edges[:, 1:] + edges[:, :-1])
    pair = (w[:, :, None] * w[:, None, :]
            * (m[:, :, None] - m[:, None, :]).abs()).sum(dim=(1, 2))
    own = (w * w * (edges[:, 1:] - edges[:, :-1])).sum(dim=1) / 3.0
    return (pair + own).mean()


def loss_of(params: Params, batch: Dict[str, torch.Tensor], draws: Dict,
            step: int, update: bool, spec: Spec):
    """(loss, interlevel) of one training step."""
    out = render_rays(params, batch["rays_o"], batch["rays_d"], spec, step,
                      draws, update, batch.get("img_idx"))
    il = interlevel(out["edges"], out["weights"], out["proposal_edges"],
                    out["proposal_weights"])
    loss = ((out["rgb"] - batch["target"]) ** 2).mean() \
        + spec.interlevel_w * il \
        + spec.distortion_w * distortion(out["edges"], out["weights"])
    return loss, il


@torch.no_grad()
def radam(params: Params, grads: Params, mu: Params, nu: Params, t: int,
          lr: float) -> None:
    """RAdam on the leaves of ``grads`` (the others keep their values and
    moments): eps 1e-15, no weight decay."""
    adaptive, rect = rectified(t)
    lr32 = np.float32(lr)
    for k, g in grads.items():
        nu[k].mul_(BETA2).add_(g * g * (1.0 - BETA2))
        mu[k].mul_(BETA1).add_(g * (1.0 - BETA1))
        if adaptive:
            params[k].sub_(mu[k] * float(lr32 * rect)
                           / (torch.sqrt(nu[k]) + 1e-15))


def run_steps(params: Params, batches: List[Dict[str, torch.Tensor]],
              draws: List[Dict], spec: Spec, step0: int, opt_step0: int,
              since0: int) -> Dict:
    """Train ``params`` (in place) from zero moments over the batches and
    draws of steps ``step0``, ``step0 + 1``, ..., the optimizer's counter
    from ``opt_step0``, ``since0`` steps after the proposals' last update.
    Returns each step's loss and interlevel loss and whether it updated
    the proposals, the first step's gradient norm per leaf (0 for a leaf
    it did not update) and per row of the field's table."""
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    since = since0
    out = {"losses": [], "interlevels": [], "updates": []}
    for i, (batch, dr) in enumerate(zip(batches, draws)):
        step = step0 + i
        update = update_due(spec, step, since)
        names = [k for k in params
                 if update or not k.startswith("proposal_")]
        leaves = {k: v.detach().requires_grad_(k in names)
                  for k, v in params.items()}
        loss, il = loss_of(leaves, batch, dr, step, update, spec)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        if i == 0:
            out["grad_norms"] = {k: float(torch.linalg.norm(grads[k]))
                                 if k in grads else 0.0 for k in params}
            g = grads["table"]
            out["table_rows"] = torch.linalg.norm(g, dim=1).cpu().numpy()
        out["losses"].append(float(loss.detach()))
        out["interlevels"].append(float(il.detach()))
        out["updates"].append(update)
        t = opt_step0 + i + 1
        radam(params, grads, mu, nu, t, lr_at(spec, t - 1))
        since = (0 if update else since) + 1
    return out


# ---- evaluation ----

@torch.no_grad()
def render_image(params: Params, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 spec: Spec, block: int = 8192) -> Dict[str, torch.Tensor]:
    """rgb ``[N, 3]``, depth and acc ``[N]`` of an evaluation render of
    flat rays, in blocks of ``block`` rays."""
    outs = {"rgb": [], "depth": [], "acc": []}
    for s in range(0, rays_o.shape[0], block):
        o = render_rays(params, rays_o[s:s + block], rays_d[s:s + block], spec)
        for k in outs:
            outs[k].append(o[k])
    return {k: torch.cat(v) for k, v in outs.items()}
