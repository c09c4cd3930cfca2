"""Mip-NeRF 360 in plain PyTorch float32 (TF32 off): its two MLPs, the
frustums' Gaussians, their contraction and integrated encoding, the
proposal chain, its three losses, a clipped training step and an
evaluation render, written from the published description (Barron et al.,
CVPR 2022, arXiv:2111.12077; mip-NeRF, Barron et al., ICCV 2021, eq. 7) and
google-research/multinerf's ``configs/360.gin`` with its
``internal/configs.py`` and ``internal/models.py`` defaults. It imports
nothing of the program under test.

The equations, on camera rays ``o + t d`` (``d`` not normalized):

- spacing: ``g(t) = 1/t``, ``s = (g(t) - g(near)) / (g(far) - g(near))``;
- resampling (each of the three levels; level 0 from one interval [0, 1]
  of weight 1): ``p = softmax(log(w + 0))`` over the non-empty intervals,
  ``n`` centres at the inverse CDF of ``linspace(0, 1 - u_max, n)`` plus
  one jitter a ray times ``(1 - u_max)/(n - 1) - eps`` (``u_max = eps +
  (1 - eps)/n``), or of ``(k + 1/2)/n`` in evaluation; edges the centres'
  midpoints, the first ``max(0, 2 c_0 - m_0)``, the last ``min(1, 2
  c_{n-1} - m_{n-2})``; no gradient;
- frustum (mip-NeRF eq. 7): ``t_mu``, ``t_delta`` the interval's centre
  and half-width, ``mu_t = t_mu + 2 t_mu t_delta^2 / (3 t_mu^2 +
  t_delta^2)``, ``sigma_t^2 = t_delta^2/3 - 4/15 t_delta^4 (12 t_mu^2 -
  t_delta^2) / (3 t_mu^2 + t_delta^2)^2``, ``sigma_r^2 = r^2 (t_mu^2/4 +
  5/12 t_delta^2 - 4/15 t_delta^4 / (3 t_mu^2 + t_delta^2))``, ``r = 2 /
  (sqrt(12) focal)``; mean ``o + mu_t d``, covariance ``sigma_t^2 d d^T +
  sigma_r^2 (I - d d^T / |d|^2)``, as 3 x 3 matrices;
- contraction: ``x`` inside the unit ball, else ``(2 - 1/|x|) x/|x|``; the
  covariance ``J S J^T`` with the Jacobian ``J = (2/r - 1/r^2) I -
  (2/r^3)(1 - 1/r) x x^T`` (matrix products);
- IPE: ``[sin(2^l m) exp(-4^l v/2), cos(2^l m) exp(-4^l v/2)]``, ``l =
  0..11``, ``v`` the covariance's diagonal; the sines of every degree
  first (degree-major, then x, y, z);
- the MLPs: ReLU layers with biases, the IPE concatenated after the 5th
  layer's output (``[h, ipe]``), density ``softplus(w h + b - 1)``; the
  NeRF MLP's bottleneck (linear), its view layer on ``[bottleneck, d/|d|,
  sin(2^l d/|d|), cos(2^l d/|d|)]`` (``l = 0..3``) with ReLU, rgb
  ``1.002 sigmoid(.) - 0.001``; one proposal MLP for both proposal levels;
- weights: ``alpha_i = 1 - exp(-sigma_i (t_{i+1} - t_i) |d|)``, the last
  interval opaque, times the product of ``1 - alpha_j`` before it (as
  ``exp`` of the cumulated sum); rgb ``sum w c``, depth ``sum w t_mid``;
- the loss: the mean Charbonnier ``sqrt(x^2 + 0.001^2)`` of the colour, +
  per proposal level the interlevel loss (``nerfacto.py``'s: the NeRF
  weights and edges detached), + 0.01 x the interval distortion on the
  NeRF level's edges in s;
- the optimizer: the gradients scaled by ``min(1, 1e-3 / (eps + |g|))``,
  ``|g|`` their global norm, then RAdam (beta 0.9, 0.999, eps 1e-6, no
  weight decay; ``step.py``'s rectifier at beta2 0.999) at the learning
  rate ``log_lerp(t / 250k, 2e-3, 2e-5)`` times ``0.01 + 0.99 sin(pi/2
  clip(t / 512, 0, 1))``.

Departures from the paper and its published code, each as the program
shares it:

1. RAdam stands in for Adam (its rectifier is ~0.99 at step 6000), with
   one step counter and moments from zero at the window's start step.
2. The anneal of the resampling weights, the dilation of the proposal
   histograms and the icosahedral lift of the IPE (multinerf's later
   additions) are not taken: the weights' exponent is 1, the histograms
   are used as they are and the IPE reads the covariance's axis diagonal,
   as the paper has it.
3. float32 products, where the TPU's default matmul precision rounds
   operands to bfloat16; the frustums' Gaussians and their contraction in
   float64 (in float32 the contracted covariance of a far interval loses
   up to 1% of its least axis to cancellation, and the IPE's high degrees
   turn that into ~4e-3 of a feature).
4. ``softplus`` is torch's (linear above 20, as ``jax.nn.softplus`` is
   not); the compositing takes no background colour (the last interval
   is opaque, so it would take no weight).
5. The skip connection follows multinerf: the encoded input is
   concatenated to the 5th layer's output, so the 6th layer reads ``W +
   72``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as nnf

from nerfbench.reference import model
from nerfbench.reference.nerfacto import distortion, interlevel

Params = Dict[str, torch.Tensor]
EPS = float(np.finfo(np.float32).eps)
BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-6
LR_FINAL, MAX_STEPS, DELAY_STEPS, DELAY_MULT = 2e-5, 250_000, 512, 0.01
GRAD_MAX_NORM, CHARB = 1e-3, 1e-3
INTERLEVEL_W = 1.0
IPE_DEG, VIEW_DEG, SKIP = 12, 4, 4


@dataclasses.dataclass(frozen=True)
class Spec:
    netdepth: int
    netwidth: int
    prop_netdepth: int
    prop_netwidth: int
    bottleneck: int
    views_width: int
    proposal_samples: Tuple[int, ...]
    nerf_samples: int
    near: float
    far: float
    n_rand: int
    lrate: float
    distortion_w: float
    radius: float
    # The control: every matrix product's operands rounded to TF32.
    tf32: bool = False

    @property
    def samples(self) -> Tuple[int, ...]:
        return tuple(self.proposal_samples) + (self.nerf_samples,)


def make_spec(args: Dict, focal: float) -> Spec:
    """The reference's settings from a Mip-NeRF 360 configuration's flags
    (multinerf's defaults where a flag is left out) and the scene's focal
    length."""
    a = {"netdepth": 8, "netwidth": 1024, "prop_netdepth": 4,
         "prop_netwidth": 256, "bottleneck_width": 256,
         "netwidth_views": 128, "proposal_samples": "64,64",
         "nerf_samples": 32, "near_plane": 0.05, "far_plane": 1000.0,
         "N_rand": 16384, "lrate": 2e-3, "distortion_loss_weight": 0.01}
    a.update(args)
    return Spec(
        netdepth=int(a["netdepth"]), netwidth=int(a["netwidth"]),
        prop_netdepth=int(a["prop_netdepth"]),
        prop_netwidth=int(a["prop_netwidth"]),
        bottleneck=int(a["bottleneck_width"]),
        views_width=int(a["netwidth_views"]),
        proposal_samples=tuple(int(x) for x in
                               str(a["proposal_samples"]).split(",")),
        nerf_samples=int(a["nerf_samples"]), near=float(a["near_plane"]),
        far=float(a["far_plane"]), n_rand=int(a["N_rand"]),
        lrate=float(a["lrate"]),
        distortion_w=float(a["distortion_loss_weight"]),
        radius=float(2.0 / np.sqrt(12.0) / focal))


def _trunk(prefix: str, depth: int, width: int, d_in: int):
    out, cur = [], d_in
    for i in range(depth):
        out.append((f"{prefix}.trunk.{i}", (cur, width)))
        cur = width + (d_in if i % SKIP == 0 and i > 0 else 0)
    return out, cur


def layer_shapes(spec: Spec) -> List[Tuple[str, Tuple[int, int]]]:
    """Every layer ``(name, (in, out))`` by the program's leaf names (each
    has ``.w`` and ``.b``): the proposal MLP, then the NeRF MLP."""
    d = 6 * IPE_DEG
    prop, head = _trunk("proposal_mlp", spec.prop_netdepth,
                        spec.prop_netwidth, d)
    prop.append(("proposal_mlp.density", (head, 1)))
    nerf, head = _trunk("nerf_mlp", spec.netdepth, spec.netwidth, d)
    nerf += [("nerf_mlp.density", (head, 1)),
             ("nerf_mlp.bottleneck", (head, spec.bottleneck)),
             ("nerf_mlp.views.0", (spec.bottleneck + 3 + 6 * VIEW_DEG,
                                   spec.views_width)),
             ("nerf_mlp.rgb", (spec.views_width, 3))]
    return prop + nerf


def make_params(spec: Spec, seed: int, device) -> Params:
    """The benchmark's weights from ``seed``: one generator on ``device``,
    one uniform draw over every layer's weights in turn, each ``U(+-sqrt(6
    / fan_in))`` (``he_uniform``), and zero biases."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    layers = layer_shapes(spec)
    sizes = [a * b for _, (a, b) in layers]
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out: Params = {}
    off = 0
    for (name, (a, b)), n in zip(layers, sizes):
        bound = math.sqrt(6.0 / a)
        out[f"{name}.w"] = (flat[off:off + n] * (2 * bound) - bound).view(a, b)
        out[f"{name}.b"] = torch.zeros(b, device=device)
        off += n
    return out


# ---- the nets ----

def _mm(a: torch.Tensor, b: torch.Tensor, spec: Spec) -> torch.Tensor:
    if spec.tf32:
        a, b = model._RoundTF32.apply(a), model._RoundTF32.apply(b)
    return a @ b


def _dense(params: Params, name: str, x: torch.Tensor, spec: Spec):
    return _mm(x, params[f"{name}.w"], spec) + params[f"{name}.b"]


def _trunk_out(params: Params, prefix: str, depth: int, x: torch.Tensor,
               spec: Spec) -> torch.Tensor:
    h = x
    for i in range(depth):
        h = torch.relu(_dense(params, f"{prefix}.trunk.{i}", h, spec))
        if i % SKIP == 0 and i > 0:
            h = torch.cat([h, x], dim=-1)
    return h


def prop_density(params: Params, x: torch.Tensor, spec: Spec) -> torch.Tensor:
    h = _trunk_out(params, "proposal_mlp", spec.prop_netdepth, x, spec)
    return nnf.softplus(_dense(params, "proposal_mlp.density", h, spec)[:, 0]
                        - 1.0)


def nerf(params: Params, x: torch.Tensor, views: torch.Tensor, spec: Spec):
    """(density ``[M]``, rgb ``[M, 3]``) of the NeRF MLP."""
    h = _trunk_out(params, "nerf_mlp", spec.netdepth, x, spec)
    sigma = nnf.softplus(_dense(params, "nerf_mlp.density", h, spec)[:, 0]
                         - 1.0)
    b = _dense(params, "nerf_mlp.bottleneck", h, spec)
    v = torch.relu(_dense(params, "nerf_mlp.views.0",
                          torch.cat([b, views], dim=-1), spec))
    rgb = torch.sigmoid(_dense(params, "nerf_mlp.rgb", v, spec))
    return sigma, rgb * 1.002 - 0.001


# ---- the Gaussians ----

def gaussians(o: torch.Tensor, d: torch.Tensor, t: torch.Tensor,
              radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean ``[N, S, 3]``, covariance ``[N, S, 3, 3]``) of the frustums
    between depths ``t`` ``[N, S + 1]``."""
    t0, t1 = t[:, :-1], t[:, 1:]
    c, h = 0.5 * (t0 + t1), 0.5 * (t1 - t0)
    h2 = h * h
    den = torch.clamp(3 * c * c + h2, min=EPS)
    mu_t = c + 2 * c * h2 / den
    var_t = h2 / 3 - (4 / 15) * h2 * h2 * (12 * c * c - h2) / (den * den)
    var_r = (c * c / 4 + (5 / 12) * h2
             - (4 / 15) * h2 * h2 / den) * (radius * radius)
    mean = o[:, None, :] + d[:, None, :] * mu_t[..., None]
    dd = d[:, :, None] * d[:, None, :]  # [N, 3, 3]
    null = torch.eye(3, device=d.device, dtype=d.dtype) - dd / torch.clamp(
        (d * d).sum(-1), min=EPS)[:, None, None]
    cov = (var_t[..., None, None] * dd[:, None]
           + var_r[..., None, None] * null[:, None])
    return mean, cov


def contract(x: torch.Tensor) -> torch.Tensor:
    r2 = torch.clamp((x * x).sum(-1, keepdim=True), min=EPS)
    return torch.where(r2 <= 1, x, (2 * torch.sqrt(r2) - 1) / r2 * x)


def contract_cov(mean: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """``J cov J^T`` with the contraction's Jacobian at ``mean``."""
    r = torch.sqrt(torch.clamp((mean * mean).sum(-1), min=EPS))
    rs = torch.where(r <= 1, torch.ones_like(r), r)
    eye = torch.eye(3, device=mean.device, dtype=mean.dtype)
    jac = ((2 / rs - 1 / rs ** 2)[..., None, None] * eye
           - (2 / rs ** 3 * (1 - 1 / rs))[..., None, None]
           * mean[..., :, None] * mean[..., None, :])
    jac = torch.where((r <= 1)[..., None, None], eye, jac)
    return jac @ cov @ jac.transpose(-1, -2)


def ipe(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    sc = 2.0 ** torch.arange(IPE_DEG, device=mean.device,
                             dtype=torch.float32)
    m = (mean[..., None, :] * sc[:, None]).flatten(-2)
    v = (var[..., None, :] * (sc ** 2)[:, None]).flatten(-2)
    return torch.cat([torch.sin(m) * torch.exp(-0.5 * v),
                      torch.cos(m) * torch.exp(-0.5 * v)], dim=-1)


def features(o, d, t, spec: Spec) -> torch.Tensor:
    """The IPE ``[N * S, 72]`` of the intervals between depths ``t``: the
    Gaussians and their contraction in float64, the encoding in float32."""
    mean, cov = gaussians(o.double(), d.double(), t.double(), spec.radius)
    cov = contract_cov(mean, cov)
    var = torch.diagonal(cov, dim1=-2, dim2=-1)
    f = ipe(contract(mean).float(), var.float())
    return f.reshape(-1, f.shape[-1])


def view_enc(dirs: torch.Tensor) -> torch.Tensor:
    sc = 2.0 ** torch.arange(VIEW_DEG, device=dirs.device,
                             dtype=torch.float32)
    x = (dirs[..., None, :] * sc[:, None]).flatten(-2)
    return torch.cat([dirs, torch.sin(x), torch.cos(x)], dim=-1)


# ---- the chain ----

def depths(s: torch.Tensor, spec: Spec) -> torch.Tensor:
    return 1.0 / (s * (1.0 / spec.far) + (1.0 - s) * (1.0 / spec.near))


def resample(edges: torch.Tensor, w: torch.Tensor, n: int,
             u: Optional[torch.Tensor]) -> torch.Tensor:
    """``n + 1`` new edges from the step function ``w`` on ``edges``."""
    e, w = edges.detach(), w.detach()
    logit = torch.where(e[:, 1:] > e[:, :-1], torch.log(w), -math.inf)
    p = torch.softmax(logit, dim=-1)
    cdf = torch.cat([torch.zeros_like(p[:, :1]),
                     torch.clamp(torch.cumsum(p[:, :-1], dim=-1), max=1.0),
                     torch.ones_like(p[:, :1])], dim=-1)
    if u is None:
        q = ((torch.arange(n, device=e.device, dtype=torch.float32) + 0.5)
             / n).expand(e.shape[0], n)
    else:
        u_max = EPS + (1 - EPS) / n
        q = (torch.linspace(0.0, 1.0 - u_max, n, device=e.device)
             + u * ((1 - u_max) / (n - 1) - EPS))
    q = q.contiguous()
    j = torch.searchsorted(cdf.contiguous(), q, right=True)
    lo = torch.clamp(j - 1, min=0)
    hi = torch.clamp(j, max=cdf.shape[1] - 1)
    c0, c1 = cdf.gather(1, lo), cdf.gather(1, hi)
    f = torch.clamp((q - c0) / torch.clamp(c1 - c0, min=EPS ** 2), 0.0, 1.0)
    c = e.gather(1, lo) + f * (e.gather(1, hi) - e.gather(1, lo))
    m = (c[:, 1:] + c[:, :-1]) / 2
    return torch.cat([torch.clamp(2 * c[:, :1] - m[:, :1], min=0.0), m,
                      torch.clamp(2 * c[:, -1:] - m[:, -1:], max=1.0)], dim=1)


def weights_of(sigma: torch.Tensor, t: torch.Tensor,
               d: torch.Tensor) -> torch.Tensor:
    tau = sigma * (t[:, 1:] - t[:, :-1]) * torch.linalg.norm(d, dim=-1,
                                                             keepdim=True)
    tau = torch.cat([tau[:, :-1], torch.full_like(tau[:, -1:], math.inf)],
                    dim=1)
    before = torch.cat([torch.zeros_like(tau[:, :1]),
                        torch.cumsum(tau[:, :-1], dim=1)], dim=1)
    return torch.nan_to_num((1.0 - torch.exp(-tau)) * torch.exp(-before))


def render_rays(params: Params, o: torch.Tensor, d: torch.Tensor, spec: Spec,
                draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """Render ``[N]`` rays: training with ``draws`` (``u`` ``[N, 3]``), or
    evaluation without."""
    u = (draws or {}).get("u")
    n = o.shape[0]
    jit = (lambda k: None) if u is None else (lambda k: u[:, k:k + 1])  # noqa
    edges = resample(torch.tensor([[0.0, 1.0]], device=o.device).expand(n, 2),
                     torch.ones((n, 1), device=o.device), spec.samples[0],
                     jit(0))
    prop_edges, prop_w = [], []
    for lvl in range(len(spec.proposal_samples)):
        t = depths(edges, spec)
        with torch.no_grad():
            f = features(o, d, t, spec)
        w = weights_of(prop_density(params, f, spec).reshape(n, -1), t, d)
        prop_edges.append(edges)
        prop_w.append(w)
        edges = resample(edges, w, spec.samples[lvl + 1], jit(lvl + 1))
    t = depths(edges, spec)
    s = t.shape[1] - 1
    with torch.no_grad():
        f = features(o, d, t, spec)
    dirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    views = view_enc(dirs)[:, None].expand(n, s, 3 + 6 * VIEW_DEG)
    sigma, rgb = nerf(params, f, views.reshape(n * s, -1), spec)
    w = weights_of(sigma.reshape(n, s), t, d)
    mid = (t[:, 1:] + t[:, :-1]) / 2
    return {"rgb": (w[..., None] * rgb.reshape(n, s, 3)).sum(dim=1),
            "depth": (w * mid).sum(dim=1), "acc": w.sum(dim=1),
            "weights": w, "edges": edges, "proposal_edges": prop_edges,
            "proposal_weights": prop_w}


# ---- the step ----

def loss_of(params: Params, batch: Dict[str, torch.Tensor], draws: Dict,
            spec: Spec):
    """(loss, interlevel) of one training step."""
    out = render_rays(params, batch["rays_o"], batch["rays_d"], spec, draws)
    il = interlevel(out["edges"], out["weights"], out["proposal_edges"],
                    out["proposal_weights"])
    data = torch.sqrt((out["rgb"] - batch["target"]) ** 2 + CHARB ** 2).mean()
    return (data + INTERLEVEL_W * il
            + spec.distortion_w * distortion(out["edges"], out["weights"]),
            il)


def lr_at(spec: Spec, t: int) -> float:
    f = min(max(t / MAX_STEPS, 0.0), 1.0)
    lr = math.exp(f * (math.log(LR_FINAL) - math.log(spec.lrate))
                  + math.log(spec.lrate))
    delay = DELAY_MULT + (1 - DELAY_MULT) * math.sin(
        0.5 * math.pi * min(max(t / DELAY_STEPS, 0.0), 1.0))
    return float(np.float32(delay * lr))


def rectified(t: int):
    """(adaptive, step factor) of RAdam's step ``t`` at beta2 0.999,
    float32."""
    f32 = np.float32
    b2t = np.power(f32(BETA2), f32(t))
    n_max = f32(2.0 / (1.0 - BETA2) - 1.0)
    n_sma = n_max - f32(2.0) * f32(t) * b2t / (f32(1.0) - b2t)
    rect = np.sqrt(np.maximum((f32(1.0) - b2t) * (n_sma - f32(4.0))
                              / (n_max - f32(4.0)) * (n_sma - f32(2.0)) / n_sma
                              * n_max / (n_max - f32(2.0)), f32(0.0)))
    return bool(n_sma >= f32(5.0)), f32(rect / (f32(1.0) - np.power(
        f32(BETA1), f32(t))))


@torch.no_grad()
def clip(grads: Params) -> None:
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    scale = min(1.0, GRAD_MAX_NORM / (EPS + float(norm)))
    for g in grads.values():
        g.mul_(scale)


@torch.no_grad()
def radam(params: Params, grads: Params, mu: Params, nu: Params, t: int,
          lr: float) -> None:
    adaptive, rect = rectified(t)
    step = float(np.float32(lr) * rect)
    for k, g in grads.items():
        nu[k].mul_(BETA2).add_(g * g * (1.0 - BETA2))
        mu[k].mul_(BETA1).add_(g * (1.0 - BETA1))
        if adaptive:
            params[k].sub_(mu[k] * step / (torch.sqrt(nu[k]) + ADAM_EPS))


def run_steps(params: Params, batches: List[Dict[str, torch.Tensor]],
              draws: List[Dict], spec: Spec, opt_step0: int) -> Dict:
    """Train ``params`` (in place) from zero moments over the batches and
    draws, the optimizer's counter from ``opt_step0``. Returns each step's
    loss and interlevel loss, the first step's clipped gradient norm per
    leaf and per row (input feature) of the NeRF MLP's first layer."""
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    out = {"losses": [], "interlevels": []}
    for i, (batch, dr) in enumerate(zip(batches, draws)):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss, il = loss_of(leaves, batch, dr, spec)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        clip(grads)
        if i == 0:
            out["grad_norms"] = {k: float(torch.linalg.norm(g))
                                 for k, g in grads.items()}
            out["table_rows"] = torch.linalg.norm(
                grads["nerf_mlp.trunk.0.w"], dim=1).cpu().numpy()
        out["losses"].append(float(loss.detach()))
        out["interlevels"].append(float(il.detach()))
        t = opt_step0 + i + 1
        radam(params, grads, mu, nu, t, lr_at(spec, t - 1))
        del leaves, grads, loss
    return out
