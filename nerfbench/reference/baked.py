"""The baked snapshot of the block-hash field, and its renderer, in plain
PyTorch: the bake of ``render/baked.py``'s ``bake_field`` and the render
of its ``baked_render_rays`` (deferred shading), worked out again from the
reference's field (``grid.py``, ``model.py``) at the snapshot's storage
dtype (bfloat16), in float32 otherwise. It imports nothing of the program.

The bake (``bake``):

- the field's density and geometry features at every vertex of a
  ``res^3``-voxel lattice over the scene box (the sigma net's outputs;
  the density zero outside the box), stored as bfloat16;
- visibility: every 4th pixel's ray of every training camera, 128 uniform
  depths in its box interval, the standard compositing weights (a 1e10
  last interval) scatter-maxed into a 32^3 cell grid; a vertex whose cell
  and its 26 neighbours all stay under a weight of 1e-3 gets a density
  of -1e4;
- the density in halo'd tiles of 5^3 vertices, one 128-lane row a
  4^3-voxel block; the geometry features at ``res / 2`` in rows of a
  voxel's 8 corners x 16 lanes.

The render (``render_rays``): 128 uniform depths in each ray's box
interval (clipped to near, far); the density interpolated trilinearly in
its tile (the weights in float32 where the program reads its tiles on the
card, rounded to bfloat16 on the CPU, as ``render/baked.py``'s
``_sigma_interp`` and ``_tent_interp`` do); the compositing weights; depth
``sum w z``; the 4 largest weights rescaled to the ray's opacity, their
geometry features interpolated (corner weights rounded to bfloat16, the
rows' dtype) and summed with those weights; one colour-net pass a ray on
``[SH(d), features]``, sigmoid times the opacity.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as nnf

from nerfbench.reference import grid, model, render
from nerfbench.reference.spec import Spec

BLOCK, SIDE, LANES = 4, 5, 128


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def vertex_query(params, spec: Spec, pts: torch.Tensor):
    """(density ``[N]``, zero outside the box; geometry features ``[N,
    geo]``) of the field at ``pts``."""
    feats, keep = grid.encode(pts, params["table"], spec)
    net = spec.nets[-1]
    h = torch.relu(model._mm(feats, params[f"{net}.sigma_net.0.w"], spec))
    h = model._mm(h, params[f"{net}.sigma_net.1.w"], spec)
    return torch.where(keep, h[:, 0], 0.0), h[:, 1:]


def ray_box(ro, rd, bmin, bmax, near: float, far: float):
    inv = 1.0 / torch.where(rd.abs() < 1e-9, 1e-9, rd)
    ta, tb = (bmin - ro) * inv, (bmax - ro) * inv
    t0 = torch.clamp_min(torch.minimum(ta, tb).amax(dim=-1), near)
    t1 = torch.clamp_max(torch.maximum(ta, tb).amin(dim=-1), far)
    return t0, torch.maximum(t1, t0)


def comp_weights(sigma, z, rd):
    n = z.shape[0]
    dists = torch.cat([z[:, 1:] - z[:, :-1], z.new_full((n, 1), 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rd, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(torch.cat([z.new_ones((n, 1)),
                                     1.0 - alpha + 1e-10], dim=-1), dim=-1)
    return alpha * trans[:, :-1]


def visibility(params, spec: Spec, cameras: Dict, res: int,
               bmin: torch.Tensor, bmax: torch.Tensor, cells: int = 32,
               sub: int = 4, threshold: float = 1e-3) -> torch.Tensor:
    """``[(res + 1)^3]`` bool: the vertices a training ray sees."""
    dev = bmin.device
    H, W = int(cameras["H"]) // sub, int(cameras["W"]) // sub
    R = max(4, min(cells, H, W))
    ts = render.linspace01(128, dev)
    seen = torch.zeros(R ** 3, device=dev)
    for c2w in cameras["poses"]:
        ro, rd = render.image_rays(H, W, cameras["focal"] / sub,
                                   _f32(c2w, dev)[:3, :4])
        t0, t1 = ray_box(ro, rd, bmin, bmax, cameras["near"], cameras["far"])
        z = t0[:, None] + (t1 - t0)[:, None] * ts[None, :]
        pts = (ro[:, None] + rd[:, None] * z[..., None]).reshape(-1, 3)
        sigma = torch.cat([vertex_query(params, spec, c)[0]
                           for c in pts.split(1 << 18)]).reshape(z.shape)
        w = comp_weights(sigma, z, rd).reshape(-1)
        v = torch.clamp(((pts - bmin) / (bmax - bmin) * R).to(torch.int32),
                        0, R - 1).long()
        seen.scatter_reduce_(0, (v[:, 0] * R + v[:, 1]) * R + v[:, 2], w,
                             "amax", include_self=True)
    keep = (seen >= threshold).float().reshape(1, 1, R, R, R)
    keep = nnf.max_pool3d(keep, 3, stride=1, padding=1)[0, 0] > 0
    vi = torch.clamp(torch.arange(res + 1, device=dev) * R // res, 0, R - 1)
    return keep[vi[:, None, None], vi[None, :, None],
                vi[None, None, :]].reshape(-1)


@torch.no_grad()
def bake(params, spec: Spec, cameras: Dict, res: int = 256) -> Dict:
    """The snapshot: ``sigma`` ``[n_blocks, 128]`` and ``geo`` ``[R^3,
    128]`` (bfloat16), the box, and the colour net's weights."""
    dev = params["table"].device
    bmin, bmax = _f32(spec.bbox_min, dev), _f32(spec.bbox_max, dev)
    V = res + 1
    voxel = _f32((np.asarray(spec.bbox_max, np.float32)
                  - np.asarray(spec.bbox_min, np.float32)) / res, dev)
    sig = torch.empty(V ** 3, dtype=torch.bfloat16, device=dev)
    geo = torch.empty((V ** 3, spec.geo), dtype=torch.bfloat16, device=dev)
    for s in range(0, V ** 3, 1 << 18):
        ids = torch.arange(s, min(s + (1 << 18), V ** 3), device=dev)
        vi = torch.stack([ids // (V * V), (ids // V) % V, ids % V], -1).float()
        a, b = vertex_query(params, spec, bmin + vi * voxel)
        sig[s:s + ids.shape[0]] = a.to(torch.bfloat16)
        geo[s:s + ids.shape[0]] = b.to(torch.bfloat16)
    keep = visibility(params, spec, cameras, res, bmin, bmax)
    sig = torch.where(keep, sig, torch.tensor(-1e4, dtype=torch.bfloat16,
                                              device=dev))
    E = res // BLOCK
    lane = torch.arange(LANES, device=dev)[None, :]
    blk = torch.arange(E ** 3, device=dev)[:, None]
    live = lane < SIDE ** 3
    vid = (((blk // (E * E) * BLOCK + lane // (SIDE * SIDE)) * V
            + ((blk // E) % E * BLOCK + (lane // SIDE) % SIDE)) * V
           + (blk % E * BLOCK + lane % SIDE))
    sigma = sig[torch.where(live, vid, 0).reshape(-1)].view(E ** 3, LANES)
    sigma = sigma * live.to(sigma.dtype)
    R = res // 2
    corners = torch.zeros((R ** 3, 8, 16), dtype=torch.bfloat16, device=dev)
    vox = torch.arange(R ** 3, device=dev)
    x, y, z = vox // (R * R), (vox // R) % R, vox % R
    for c, (dx, dy, dz) in enumerate(np.ndindex(2, 2, 2)):
        v = (2 * (x + dx) * V + 2 * (y + dy)) * V + 2 * (z + dz)
        corners[:, c, :spec.geo] = geo[v]
    net = spec.nets[-1]
    return {"sigma": sigma, "geo": corners.view(R ** 3, LANES), "res": res,
            "bmin": bmin, "bmax": bmax, "geo_dim": spec.geo,
            "color": [params[f"{net}.color_net.{i}.w"] for i in range(3)]}


def _tent(table: torch.Tensor, row: torch.Tensor, p,
          f32_weights: bool) -> torch.Tensor:
    """The tile rows' trilinear interpolation at in-tile positions ``p``:
    the tent weights ``max(0, 1 - |l - p|)`` of the 8 bracketing lanes (the
    others weigh 0), their product over x, y, z."""
    base = [torch.clamp(torch.floor(q), 0, SIDE - 2) for q in p]
    out = torch.zeros_like(p[0])
    for dx, dy, dz in np.ndindex(2, 2, 2):
        w = None
        for b, d, q in zip(base, (dx, dy, dz), p):
            t = torch.clamp_min(1.0 - ((b + d) - q).abs(), 0.0)
            w = t if w is None else w * t
        if not f32_weights:
            w = w.to(torch.bfloat16).float()
        lane = (((base[0] + dx) * SIDE + base[1] + dy) * SIDE
                + base[2] + dz).long()
        out = out + table[row, lane].float() * w
    return out


@torch.no_grad()
def render_rays(baked: Dict, ro: torch.Tensor, rd: torch.Tensor, near: float,
                far: float, spec: Spec, n: int = 128, k: int = 4
                ) -> Dict[str, torch.Tensor]:
    """rgb ``[N, 3]`` and depth ``[N]`` of rays through the snapshot
    (``spec.tf32``: the colour net's products at TF32, the control)."""
    dev = ro.device
    res, bmin, bmax = baked["res"], baked["bmin"], baked["bmax"]
    E = res // BLOCK
    t0, t1 = ray_box(ro, rd, bmin, bmax, near, far)
    z = t0[:, None] + (t1 - t0)[:, None] * render.linspace01(n, dev)[None, :]
    scale = res / (bmax - bmin)
    rel = [torch.clamp((ro[:, None, a] + rd[:, None, a] * z - bmin[a])
                       * scale[a], 0.0, res - 1e-4) for a in range(3)]
    blk = [torch.clamp(torch.div(r, BLOCK, rounding_mode="floor")
                       .to(torch.int32), 0, E - 1) for r in rel]
    row = ((blk[0] * E + blk[1]) * E + blk[2]).long().reshape(-1)
    p = [(r - b.float() * BLOCK).reshape(-1) for r, b in zip(rel, blk)]
    sigma = _tent(baked["sigma"], row, p, dev.type == "cuda").reshape(z.shape)
    w = comp_weights(sigma, z, rd)
    acc = w.sum(dim=-1)
    depth = (w * z).sum(dim=-1)
    ws, sel = torch.topk(w, k, dim=-1)
    ws = ws * (acc / torch.clamp_min(ws.sum(dim=-1), 1e-9))[:, None]
    R = res // 2
    s = [r.gather(1, sel) * 0.5 for r in rel]
    v0 = [torch.clamp(q.to(torch.int32), 0, R - 1) for q in s]
    vox = ((v0[0] * R + v0[1]) * R + v0[2]).long().reshape(-1)
    frac = torch.stack([q - v.float() for q, v in zip(s, v0)], dim=-1)
    rows = baked["geo"].index_select(0, vox).view(ro.shape[0], k, 8, 16)
    corner = torch.tensor(list(np.ndindex(2, 2, 2)), dtype=torch.float32,
                          device=dev)
    cw = torch.where(corner == 1.0, frac[:, :, None, :],
                     1.0 - frac[:, :, None, :]).prod(dim=-1)
    cw = cw.to(torch.bfloat16).float()
    g = (rows[..., :baked["geo_dim"]].float() * cw[..., None]).sum(dim=2)
    feat = (ws[..., None] * g).sum(dim=1)
    h = torch.cat([model.sh_encode(rd / torch.linalg.norm(rd, dim=-1,
                                                          keepdim=True)),
                   feat], dim=-1)
    for i, wt in enumerate(baked["color"]):
        h = model._mm(h, wt, spec)
        if i < len(baked["color"]) - 1:
            h = torch.relu(h)
    return {"rgb": torch.sigmoid(h) * acc[:, None], "depth": depth}


@torch.no_grad()
def render_image(baked: Dict, c2w: torch.Tensor, H: int, W: int,
                 focal: float, near: float, far: float, spec: Spec,
                 block: int = 1 << 15) -> Dict[str, torch.Tensor]:
    ro, rd = render.image_rays(H, W, focal, c2w)
    outs = {"rgb": [], "depth": []}
    for s in range(0, ro.shape[0], block):
        o = render_rays(baked, ro[s:s + block], rd[s:s + block], near, far,
                        spec)
        for key in outs:
            outs[key].append(o[key])
    return {"rgb": torch.cat(outs["rgb"]).reshape(H, W, 3),
            "depth": torch.cat(outs["depth"]).reshape(H, W)}
