"""Sample depths along rays (ops/sampling.py of the JAX package).

Random draws are inputs: the port cannot reproduce ``jax.random`` streams,
so a caller that wants jitter passes the uniform draws, and ``None`` means
the deterministic (serving) schedule. ``draw_stratified`` and ``draw_pdf_u``
make those draws from a ``torch.Generator`` on its device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def linspace01(n: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` bit for bit.

    XLA compiles jnp.linspace's ``i / (n - 1)`` into ``i * f32(1 / (n - 1))``
    with the end point exactly 1; ``torch.linspace`` rounds differently
    (it steps from both ends)."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    t = torch.arange(n, dtype=torch.float32, device=device)
    # f32(1/(n-1)) as a Python number: an exact f32 operand, no copy.
    t = t * float(np.float32(1.0 / (n - 1)))
    t[-1:].fill_(1.0)
    return t


def draw_stratified(generator: torch.Generator, n_rays: int,
                    n_samples: int) -> torch.Tensor:
    """``t_rand`` ``[n_rays, n_samples]`` uniform in [0, 1): the stratum jitter."""
    return torch.rand((n_rays, n_samples), generator=generator,
                      device=generator.device)


def draw_pdf_u(generator: torch.Generator, n_rays: int,
               n_samples: int) -> torch.Tensor:
    """Sorted inverse-CDF draws ``u = (i + xi) / S`` ``[n_rays, S]``, xi
    uniform in [0, 1) (the JAX non-det branch of ``sample_pdf``, :90-93)."""
    dev = generator.device
    xi = torch.rand((n_rays, n_samples), generator=generator, device=dev)
    i = torch.arange(n_samples, dtype=torch.float32, device=dev)
    return (i + xi) / n_samples


def stratified_z_vals(near: torch.Tensor, far: torch.Tensor, n_samples: int,
                      lindisp: bool = False,
                      t_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Coarse sample depths ``[N, n_samples]`` between ``near``/``far`` ``[N, 1]``.

    ``t_rand`` ``[N, n_samples]`` uniform draws jitter each sample within
    its stratum (the JAX ``perturb > 0`` branch); ``None`` is the linspace."""
    t_vals = linspace01(n_samples, near.device)
    if not lindisp:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    z_vals = z_vals.expand(near.shape[0], n_samples)
    if t_rand is not None:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], -1)
        lower = torch.cat([z_vals[..., :1], mids], -1)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling of ``[N, n_samples]`` depths.

    ``bins`` ``[N, B]`` edges, ``weights`` ``[N, B-1]`` unnormalized. ``u``
    ``[N, n_samples]`` sorted draws in [0, 1) (the JAX non-det branch forms
    ``(i + xi) / n``); ``None`` is the deterministic linspace."""
    weights = weights + 1e-5  # prevent nans
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [N, B]

    if u is None:
        u = linspace01(n_samples, cdf.device).expand(cdf.shape[0], n_samples)
    u = u.contiguous()

    # The count of cdf entries <= u, which the JAX version forms as an
    # [N, S, B] comparison sum; the cdf is nondecreasing, so it is exactly
    # searchsorted(side="right") without the [N, S, B] intermediate.
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, cdf.shape[-1] - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)
