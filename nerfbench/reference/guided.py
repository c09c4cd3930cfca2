"""The baked snapshot's depth-guided two-level render in plain PyTorch:
``render/baked.py``'s ``make_baked_image_renderer`` with ``guided``,
worked out again over ``baked.py``'s bake (its snapshot, tent
interpolation, ray-box interval and compositing weights). It imports
nothing of the program.

A frame of ``H x W`` (``render_image``):

- the coarse pass: ``ceil(H/g) x ceil(W/g)`` rays of the camera with its
  focal length and principal point scaled by ``1/g`` and the principal
  point moved by ``(g - 1)/(2g)``, so that coarse pixel i looks through
  the centre of its ``g x g`` block; ``n_coarse`` uniform depths in each
  ray's box interval; each ray's depths at which its cumulative weight
  first reaches 2% and 98% of its opacity;
- the window: a coarse ray with opacity above ``acc_thresh`` gives those
  two depths, the 3 x 3 neighbourhood's least and largest, widened by
  ``margin x (far - near)``; where no ray of the neighbourhood has the
  opacity, ``[near, far]``; each coarse pixel's window for its ``g x g``
  block of full-resolution rays;
- the fine pass: ``n`` uniform depths in each ray's box interval cut to
  its window (the whole box interval where the two are disjoint), the
  baked render of ``baked.py`` (the 4 largest weights' features, one
  colour-net pass a ray).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as nnf

from nerfbench.reference import baked, model, render
from nerfbench.reference.spec import Spec


def pixel_rays(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor):
    """Flat rays ``[H * W, 3]`` of the pinhole ``K`` ``[3, 3]`` (float32),
    row-major."""
    dev = c2w.device
    i, j = torch.meshgrid(torch.arange(W, dtype=torch.float32, device=dev),
                          torch.arange(H, dtype=torch.float32, device=dev),
                          indexing="xy")
    dirs = torch.stack([(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1],
                        -torch.ones_like(i)], -1)
    rd = torch.sum(dirs[..., None, :] * c2w[:3, :3], -1).reshape(-1, 3)
    return c2w[:3, -1].expand(rd.shape), rd


@torch.no_grad()
def render_rays(snap: Dict, ro: torch.Tensor, rd: torch.Tensor, near: float,
                far: float, spec: Spec, n: int,
                bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                k: int = 4) -> Dict[str, torch.Tensor]:
    """rgb ``[N, 3]``, depth, acc and the 2% / 98% depths ``[N]`` of rays
    through the snapshot at ``n`` depths in their (windowed) box
    intervals."""
    dev = ro.device
    res, bmin, bmax = snap["res"], snap["bmin"], snap["bmax"]
    E = res // baked.BLOCK
    t0, t1 = baked.ray_box(ro, rd, bmin, bmax, near, far)
    if bounds is not None:
        g0, g1 = torch.maximum(t0, bounds[0]), torch.minimum(t1, bounds[1])
        empty = g1 <= g0
        t0, t1 = torch.where(empty, t0, g0), torch.where(empty, t1, g1)
    z = t0[:, None] + (t1 - t0)[:, None] * render.linspace01(n, dev)[None, :]
    scale = res / (bmax - bmin)
    rel = [torch.clamp((ro[:, None, a] + rd[:, None, a] * z - bmin[a])
                       * scale[a], 0.0, res - 1e-4) for a in range(3)]
    blk = [torch.clamp(torch.div(r, baked.BLOCK, rounding_mode="floor")
                       .to(torch.int32), 0, E - 1) for r in rel]
    row = ((blk[0] * E + blk[1]) * E + blk[2]).long().reshape(-1)
    p = [(r - b.float() * baked.BLOCK).reshape(-1) for r, b in zip(rel, blk)]
    sigma = baked._tent(snap["sigma"], row, p,
                        dev.type == "cuda").reshape(z.shape)
    w = baked.comp_weights(sigma, z, rd)
    acc = w.sum(dim=-1)
    depth = (w * z).sum(dim=-1)
    cw = torch.cumsum(w, dim=-1)
    lo = torch.argmax((cw >= 0.02 * acc[:, None]).to(torch.uint8), dim=-1)
    hi = torch.argmax((cw >= 0.98 * acc[:, None]).to(torch.uint8), dim=-1)
    ws, sel = torch.topk(w, k, dim=-1)
    ws = ws * (acc / torch.clamp_min(ws.sum(dim=-1), 1e-9))[:, None]
    R = res // 2
    s = [r.gather(1, sel) * 0.5 for r in rel]
    v0 = [torch.clamp(q.to(torch.int32), 0, R - 1) for q in s]
    vox = ((v0[0] * R + v0[1]) * R + v0[2]).long().reshape(-1)
    frac = torch.stack([q - v.float() for q, v in zip(s, v0)], dim=-1)
    rows = snap["geo"].index_select(0, vox).view(ro.shape[0], k, 8, 16)
    corner = torch.tensor(list(np.ndindex(2, 2, 2)), dtype=torch.float32,
                          device=dev)
    cwt = torch.where(corner == 1.0, frac[:, :, None, :],
                      1.0 - frac[:, :, None, :]).prod(dim=-1)
    cwt = cwt.to(torch.bfloat16).float()
    g = (rows[..., :snap["geo_dim"]].float() * cwt[..., None]).sum(dim=2)
    feat = (ws[..., None] * g).sum(dim=1)
    h = torch.cat([model.sh_encode(rd / torch.linalg.norm(rd, dim=-1,
                                                          keepdim=True)),
                   feat], dim=-1)
    for i, wt in enumerate(snap["color"]):
        h = model._mm(h, wt, spec)
        if i < len(snap["color"]) - 1:
            h = torch.relu(h)
    return {"rgb": torch.sigmoid(h) * acc[:, None], "depth": depth,
            "acc": acc, "t_lo": z.gather(1, lo[:, None])[:, 0],
            "t_hi": z.gather(1, hi[:, None])[:, 0]}


def _blocks(snap, ro, rd, near, far, spec, n, bounds=None, block=1 << 15):
    outs: Dict[str, list] = {}
    for s in range(0, ro.shape[0], block):
        b = None if bounds is None else (bounds[0][s:s + block],
                                         bounds[1][s:s + block])
        o = render_rays(snap, ro[s:s + block], rd[s:s + block], near, far,
                        spec, n, b)
        for key, v in o.items():
            outs.setdefault(key, []).append(v)
    return {key: torch.cat(v) for key, v in outs.items()}


@torch.no_grad()
def render_image(snap: Dict, c2w: torch.Tensor, H: int, W: int,
                 focal: float, near: float, far: float, spec: Spec,
                 g: int = 4, n_coarse: int = 64, n: int = 16,
                 margin: float = 0.04, acc_thresh: float = 0.5
                 ) -> Dict[str, torch.Tensor]:
    """rgb ``[H, W, 3]`` and depth ``[H, W]`` of the guided render of one
    pose ``c2w`` ``[3, 4]``."""
    dev = c2w.device
    K = torch.tensor([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                     dtype=torch.float32, device=dev)
    Hc, Wc = -(-H // g), -(-W // g)
    off = (g - 1) / (2.0 * g)
    Kc = K * torch.tensor([[1.0 / g], [1.0 / g], [1.0]], dtype=torch.float32,
                          device=dev)
    Kc[0, 2] -= off
    Kc[1, 2] -= off
    coarse = _blocks(snap, *pixel_rays(Hc, Wc, Kc, c2w), near, far, spec,
                     n_coarse)
    hit = coarse["acc"].reshape(Hc, Wc) > acc_thresh
    lo = torch.where(hit, coarse["t_lo"].reshape(Hc, Wc), 3e38)
    hi = torch.where(hit, coarse["t_hi"].reshape(Hc, Wc), -3e38)
    lo = -nnf.max_pool2d(-lo[None, None], 3, stride=1, padding=1)[0, 0]
    hi = nnf.max_pool2d(hi[None, None], 3, stride=1, padding=1)[0, 0]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa
    m = f32(margin) * (f32(far) - f32(near))
    miss = hi < -1e37
    lo = torch.where(miss, f32(near), lo - m)
    hi = torch.where(miss, f32(far), hi + m)
    lo = lo.repeat_interleave(g, 0).repeat_interleave(g, 1)[:H, :W]
    hi = hi.repeat_interleave(g, 0).repeat_interleave(g, 1)[:H, :W]
    ro, rd = pixel_rays(H, W, K, c2w)
    fine = _blocks(snap, ro, rd, near, far, spec, n,
                   (lo.reshape(-1), hi.reshape(-1)))
    return {"rgb": fine["rgb"].reshape(H, W, 3),
            "depth": fine["depth"].reshape(H, W)}
