"""Manhattan-world structural priors (losses/priors.py of the JAX package).

PocketNeRF's first contribution (reference: structural_priors.py): a
Manhattan frame estimated from the rendered normals, floor and wall masks
from the normals' up component, and three losses on the rendered depth and
normals (Manhattan alignment, region-wise planarity, normal consistency
between spatial neighbours), summed by ``combine_structural_losses``.

The JAX functions draw from a PRNG key; here every random draw is an input
(``draw_priors`` makes them from a ``torch.Generator``, the parity tests
replay the JAX ones): the k-means start centers, the planarity pairs of the
three regions and the consistency indices. Every count and fallback stays a
tensor selected with ``torch.where`` (the identity frame below 20 confident
normals, a region's term below its count), so a step with the priors never
waits for the card.

The frame's orthogonalisation is the polar factor ``u @ vt`` of the JAX
``jnp.linalg.svd``, computed here by a fixed number of scaled Newton steps
on the 3x3 matrix with an analytic inverse: ``torch.linalg.svd`` on a CUDA
tensor synchronises with the host. The polar factor does not depend on the
signs an SVD picks for its singular vectors, so both forms give one frame
wherever the k-means centers are linearly independent (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

# Scaled Newton steps of the polar factor: quadratic convergence from the
# first step whose scale is near 1. Five reach f32 rounding (1e-7 of the
# SVD's u @ vt in f64) on random 3x3 matrices of condition number up to
# 1e5; from ~1e6 on f32 does not resolve the weakest direction, whose sign
# then no f32 form (the JAX SVD's neither) determines.
POLAR_STEPS = 6


def _normalize(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Soft normalisation ``v / sqrt(|v|^2 + 1e-8)``: a bounded jacobian at
    ``|v| -> 0`` (the hard ``1/|v|`` NaNs early training through the
    priors)."""
    return v * torch.rsqrt(torch.sum(v * v, dim=dim, keepdim=True) + 1e-8)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean of ``x`` over ``mask``, count); a zero mean on an empty mask."""
    m = mask.to(x.dtype)
    count = torch.sum(m)
    return torch.sum(x * m) / torch.clamp_min(count, 1.0), count


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    """Static structural-prior hyperparameters (the JAX PriorConfig;
    reference defaults: structural_priors.py:10,81,409-411)."""

    confidence_threshold: float = 0.4
    normal_threshold: float = 0.5
    kmeans_iters: int = 10
    n_pairs_floor: int = 100
    n_pairs_wall: int = 100
    n_pairs_other: int = 50
    n_pairs_consistency: int = 200


def consistency_pairs(n: int, with_coords: bool, config: PriorConfig) -> int:
    """How many consistency pairs an ``n``-ray batch draws."""
    return min(config.n_pairs_consistency, n // 2) if with_coords else min(100, n - 1)


def draw_priors(generator: torch.Generator, n: int, with_coords: bool,
                config: PriorConfig = PriorConfig()) -> Dict[str, torch.Tensor]:
    """The draws ``combine_structural_losses`` takes for an ``n``-ray batch,
    on the generator's device: ``centers`` ``[3, 3]`` standard normal (the
    k-means start), ``planar_floor``/``planar_wall`` ``[2, 100]`` and
    ``planar_other`` ``[2, 50]`` pair indices in ``[0, n)``, and
    ``consist_idx``: ``[min(200, n // 2)]`` in ``[0, n)`` with pixel
    coordinates, else ``[min(100, n - 1)]`` in ``[0, n - 1)``. Batches of
    fewer than 10 rays draw no pairs (their two terms are zero)."""
    dev = generator.device
    out = {"centers": torch.randn((3, 3), generator=generator, device=dev)}
    if n < 10:
        return out
    for name, k in (("floor", config.n_pairs_floor),
                    ("wall", config.n_pairs_wall),
                    ("other", config.n_pairs_other)):
        out[f"planar_{name}"] = torch.randint(0, n, (2, k), generator=generator,
                                              device=dev)
    hi = n if with_coords else n - 1
    out["consist_idx"] = torch.randint(
        0, hi, (consistency_pairs(n, with_coords, config),),
        generator=generator, device=dev)
    return out


def _cofactor3(m: torch.Tensor) -> torch.Tensor:
    """The cofactor matrix of a 3x3 ``m``, ``det(m) * inv(m).T``: its rows
    are ``r1 x r2``, ``r2 x r0``, ``r0 x r1`` (one batched cross product)."""
    return torch.linalg.cross(torch.roll(m, -1, 0), torch.roll(m, -2, 0), dim=-1)


def _det3(m: torch.Tensor, cof: torch.Tensor) -> torch.Tensor:
    """``det(m) = r0 . (r1 x r2)`` from the cofactors."""
    return torch.sum(m[0] * cof[0])


def polar_factor(a: torch.Tensor) -> torch.Tensor:
    """The orthogonal polar factor ``u @ vt`` of a 3x3 ``a`` (its SVD
    ``u s vt``) by ``POLAR_STEPS`` scaled Newton steps
    ``x <- (g x + inv(x).T / g) / 2``, ``g = sqrt(|inv x|_F / |x|_F)``
    (Higham's Frobenius scaling), with the inverse from the cofactors:
    elementwise work, no host synchronisation. A singular ``a`` (whose
    polar factor is not unique) is moved by ``1e-4 I`` first."""
    x = torch.where(torch.abs(_det3(a, _cofactor3(a))) > 1e-30, a,
                    a + 1e-4 * torch.eye(3, dtype=a.dtype, device=a.device))
    for _ in range(POLAR_STEPS):
        cof = _cofactor3(x)
        inv_t = cof / _det3(x, cof)
        g = torch.sqrt(torch.linalg.norm(inv_t) / torch.linalg.norm(x))
        x = 0.5 * (g * x + inv_t / g)
    return x


def estimate_manhattan_frame(normals: torch.Tensor,
                             confidences: Optional[torch.Tensor],
                             centers: torch.Tensor,
                             config: PriorConfig) -> torch.Tensor:
    """A 3x3 Manhattan rotation from surface normals ``[N, 3]`` (JAX :62;
    reference: structural_priors.py:16-77): k-means (k = 3,
    ``kmeans_iters`` steps, from the drawn ``centers`` normalised) over the
    unit normals whose confidence exceeds ``confidence_threshold``, then the
    polar factor of the centers (``polar_factor``) with its last column
    negated where its determinant is negative; the identity where fewer than
    20 normals are confident or the batch holds fewer than 30. Carries no
    gradient (the JAX ``stop_gradient``: the SVD's backward NaNs on repeated
    singular values)."""
    with torch.no_grad():
        n = _normalize(normals.detach())
        if confidences is not None:
            conf_mask = confidences.detach() > config.confidence_threshold
        else:
            conf_mask = torch.ones(normals.shape[0], dtype=torch.bool,
                                   device=normals.device)
        n_conf = torch.sum(conf_mask)
        w = conf_mask.to(torch.float32)
        c = _normalize(centers)
        for _ in range(config.kmeans_iters):
            assign = torch.argmax(n @ c.T, dim=-1)
            onehot = F.one_hot(assign, 3).to(torch.float32) * w[:, None]
            counts = torch.sum(onehot, dim=0)
            means = _normalize(onehot.T @ n / torch.clamp_min(counts[:, None], 1.0))
            c = torch.where(counts[:, None] > 0, means, c)
        frame = polar_factor(c.T)
        sign = torch.where(_det3(frame, _cofactor3(frame)) < 0, -1.0, 1.0)
        frame = torch.cat([frame[:, :2], frame[:, 2:] * sign], dim=1)
        valid = (n_conf >= 20) & (normals.shape[0] >= 30)
        return torch.where(valid, frame,
                           torch.eye(3, dtype=frame.dtype, device=frame.device))


def detect_planes(normals: torch.Tensor, config: PriorConfig
                  ) -> Dict[str, torch.Tensor]:
    """Floor and wall masks from the rendered normals (JAX :112; reference:
    structural_priors.py:85-154): stable normals (``|n| > 0.1``) whose unit
    up component exceeds ``normal_threshold`` are floor, those below ``1 -
    normal_threshold`` wall; both empty where fewer than 10 are stable.
    Returns the masks and their counts. (The JAX function also takes the
    depth, which it does not read.)"""
    n_norm = _normalize(normals)
    stable = torch.linalg.norm(normals, dim=-1) > 0.1
    enough = torch.sum(stable) >= 10
    up = torch.abs(n_norm[:, 2])
    floor_mask = stable & (up > config.normal_threshold) & enough
    wall_mask = stable & (up < (1.0 - config.normal_threshold)) & enough
    return {"floor_mask": floor_mask, "wall_mask": wall_mask,
            "n_floor": torch.sum(floor_mask), "n_wall": torch.sum(wall_mask)}


def cluster_wall_normals(wall_normals_2d: torch.Tensor,
                         wall_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Two wall directions (JAX :137; reference: structural_priors.py:
    157-190): the unit 2-D wall normals are split by the more similar of
    the most separated pair (the first such pair in row-major order), and
    each side's masked mean is returned (``wall_1``, ``wall_2``)."""
    nd = _normalize(wall_normals_2d)
    big = torch.where(wall_mask[:, None] & wall_mask[None, :], nd @ nd.T,
                      torch.full((), math.inf, device=nd.device))
    flat = torch.argmin(big)[None]
    # One-element index tensors: a 0-d index would be read on the host.
    i, j = flat // big.shape[1], flat % big.shape[1]
    sim1, sim2 = nd @ nd[i][0], nd @ nd[j][0]
    m1 = (sim1 > sim2) & wall_mask
    m2 = ~(sim1 > sim2) & wall_mask
    return {"wall_1": torch.stack([_masked_mean(nd[:, k], m1)[0] for k in range(2)]),
            "wall_2": torch.stack([_masked_mean(nd[:, k], m2)[0] for k in range(2)])}


def manhattan_sdf_loss(normals: torch.Tensor, frame: torch.Tensor,
                       semantic: Dict[str, torch.Tensor],
                       weight: torch.Tensor) -> torch.Tensor:
    """Floor, wall and general alignment with the frame (JAX :158;
    reference: structural_priors.py:194-256): floor normals to its up axis
    (0.5, over 50 floor rays), wall normals to the nearer horizontal axis
    (0.3, over 30 wall rays), normals within 60 degrees of an axis to it
    (0.02, over 20 such rays); the sum clipped to 0.1, times ``weight``."""
    n_norm = _normalize(normals)
    floor_loss, _ = _masked_mean(
        torch.clamp(1.0 - torch.abs(n_norm @ frame[:, 2]), 0.0, 1.0),
        semantic["floor_mask"])
    floor_term = torch.where(semantic["n_floor"] > 50, floor_loss * 0.5, 0.0)
    best = torch.maximum(torch.abs(n_norm @ frame[:, 0]),
                         torch.abs(n_norm @ frame[:, 1]))
    wall_loss, _ = _masked_mean(torch.clamp(1.0 - best, 0.0, 1.0),
                                semantic["wall_mask"])
    wall_term = torch.where(semantic["n_wall"] > 30, wall_loss * 0.3, 0.0)
    best_all = torch.amax(torch.abs(n_norm @ frame), dim=-1)
    general_loss, n_conf = _masked_mean(torch.clamp(1.0 - best_all, 0.0, 1.0),
                                        best_all > 0.5)
    general_term = torch.where(n_conf > 20, general_loss * 0.02, 0.0)
    return weight * torch.clamp(floor_term + wall_term + general_term, 0.0, 0.1)


def structured_planarity_loss(depth_map: torch.Tensor,
                              semantic: Dict[str, torch.Tensor],
                              weight: torch.Tensor,
                              draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Region-wise depth smoothness over random pairs (JAX :197; reference:
    structural_priors.py:259-318): for the floor (scale 2), the walls (1.5)
    and the rest (0.1), the mean ``|d_i - d_j|`` over the drawn pairs whose
    both rays lie in the region, where the region holds more than 5 rays.
    Zero for fewer than 10 rays."""
    if depth_map.shape[0] < 10:
        return torch.zeros((), device=depth_map.device)

    def region_term(idx, mask, count, scale):
        dd = torch.abs(depth_map[idx[0]] - depth_map[idx[1]])
        pair_w = (mask[idx[0]] & mask[idx[1]]).to(torch.float32)
        mean = torch.sum(dd * pair_w) / torch.clamp_min(torch.sum(pair_w), 1.0)
        return torch.where(count > 5, mean * scale, 0.0)

    other_mask = ~(semantic["floor_mask"] | semantic["wall_mask"])
    total = (region_term(draws["planar_floor"], semantic["floor_mask"],
                         semantic["n_floor"], 2.0)
             + region_term(draws["planar_wall"], semantic["wall_mask"],
                           semantic["n_wall"], 1.5)
             + region_term(draws["planar_other"], other_mask,
                           torch.sum(other_mask), 0.1))
    return weight * total


def spatial_normal_consistency_loss(normals: torch.Tensor,
                                    depth_map: torch.Tensor,
                                    spatial_coords: Optional[torch.Tensor],
                                    weight: torch.Tensor,
                                    idx1: Optional[torch.Tensor]
                                    ) -> torch.Tensor:
    """Normal consistency between neighbours (JAX :239; reference:
    structural_priors.py:321-371): each drawn ray ``idx1`` is paired with
    its nearest other ray in pixel coordinates (the first of equally near
    ones), or without coordinates with the next ray of the batch, and
    ``1 - cos`` of their normals is weighted by ``exp(-|d_i - d_j|)`` (and
    ``exp(-0.1 * pixel distance)``). Zero for fewer than 10 rays."""
    n = normals.shape[0]
    if n < 10:
        return torch.zeros((), device=normals.device)
    n_norm = _normalize(normals)
    if spatial_coords is not None:
        d = torch.linalg.norm(spatial_coords[idx1][:, None, :]
                              - spatial_coords[None, :, :], dim=-1)
        d = d.index_put((torch.arange(idx1.shape[0], device=d.device), idx1),
                        torch.full((), math.inf, device=d.device))
        idx2 = torch.argmin(d, dim=-1)
        spatial_dist = torch.gather(d, 1, idx2[:, None])[:, 0]
        depth_sim = torch.exp(-torch.abs(depth_map[idx1] - depth_map[idx2]))
        cos = torch.sum(n_norm[idx1] * n_norm[idx2], dim=-1)
        return weight * torch.mean(torch.exp(-spatial_dist * 0.1) * depth_sim
                                   * (1.0 - cos))
    idx2 = idx1 + 1
    depth_sim = torch.exp(-torch.abs(depth_map[idx1] - depth_map[idx2]))
    cos = torch.sum(n_norm[idx1] * n_norm[idx2], dim=-1)
    return weight * torch.mean(depth_sim * (1.0 - cos))


def combine_structural_losses(depth_pred: torch.Tensor, normals: torch.Tensor,
                              spatial_coords: Optional[torch.Tensor],
                              weights: Dict[str, torch.Tensor],
                              draws: Dict[str, torch.Tensor],
                              config: PriorConfig = PriorConfig()
                              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The three losses at ``weights`` (``manhattan``, ``planarity``,
    ``normal_consistency``: the ramped runtime weights) and their
    diagnostics (JAX :276; reference: structural_priors.py:374-451), with
    the draws of ``draw_priors``. Degenerate masks contribute exact zeros.
    The diagnostics: each loss, the floor and wall counts, and the angle in
    degrees between the two wall directions (NaN with fewer than 2 wall
    rays; ~90 in a well-formed Manhattan scene)."""
    semantic = detect_planes(normals, config)
    confidences = torch.linalg.norm(normals, dim=-1)
    frame = estimate_manhattan_frame(normals, confidences, draws["centers"],
                                     config)
    manhattan = manhattan_sdf_loss(normals, frame, semantic, weights["manhattan"])
    planarity = structured_planarity_loss(depth_pred, semantic,
                                          weights["planarity"], draws)
    consistency = spatial_normal_consistency_loss(
        normals, depth_pred, spatial_coords, weights["normal_consistency"],
        draws.get("consist_idx"))
    clusters = cluster_wall_normals(normals[:, :2], semantic["wall_mask"])
    c1, c2 = _normalize(clusters["wall_1"]), _normalize(clusters["wall_2"])
    angle = torch.rad2deg(torch.arccos(torch.clamp(torch.abs(c1 @ c2), 0.0, 1.0)))
    diag = {
        "manhattan": manhattan,
        "planarity": planarity,
        "normal_consistency": consistency,
        "semantic_floor_count": semantic["n_floor"],
        "semantic_wall_count": semantic["n_wall"],
        "wall_cluster_angle_deg": torch.where(
            semantic["n_wall"] >= 2, angle,
            torch.full((), math.nan, device=angle.device)),
    }
    return manhattan + planarity + consistency, diag
