"""The interlevel loss of nerfacto's proposal chain (Mip-NeRF 360, Barron
et al., CVPR 2022, eq. 13; nerfstudio ``model_components/losses.py``).

Each proposal level's weights must bound the field's from above: for
field interval i, ``W_i`` is the sum of the proposal's weights over its
intervals that overlap interval i (from the proposal's cumulative weights
at the field's edges, by ``searchsorted``), and the loss is the mean over
rays and field intervals of ``max(0, w_i - W_i)^2 / (w_i + 1e-7)``,
summed over the proposal levels. The field's edges and weights are
detached: the loss trains the proposal fields alone.
"""

from __future__ import annotations

from typing import Sequence

import torch

EPS = 1e-7


def outer_weights(edges: torch.Tensor, env_edges: torch.Tensor,
                  env_weights: torch.Tensor) -> torch.Tensor:
    """``[N, S]``: for each interval of ``edges`` ``[N, S + 1]`` the sum of
    ``env_weights`` ``[N, P]`` over the intervals of ``env_edges`` ``[N, P +
    1]`` that overlap it."""
    cw = torch.cat([torch.zeros_like(env_weights[..., :1]),
                    torch.cumsum(env_weights, dim=-1)], dim=-1)
    last = env_weights.shape[-1] - 1
    starts, ends = edges[..., :-1].contiguous(), edges[..., 1:].contiguous()
    lo = torch.clamp(torch.searchsorted(env_edges[..., :-1].contiguous(),
                                        starts, right=True) - 1, 0, last)
    hi = torch.clamp(torch.searchsorted(env_edges[..., 1:].contiguous(),
                                        ends, right=True), 0, last)
    return (torch.take_along_dim(cw[..., 1:], hi, dim=-1)
            - torch.take_along_dim(cw[..., :-1], lo, dim=-1))


def interlevel_loss(edges: torch.Tensor, weights: torch.Tensor,
                    proposal_edges: Sequence[torch.Tensor],
                    proposal_weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """The loss of the field's ``weights`` ``[N, S]`` on ``edges`` ``[N, S
    + 1]`` (both detached here) against each proposal level's edges and
    weights."""
    c, w = edges.detach(), weights.detach()
    loss = w.new_zeros(())
    for cp, wp in zip(proposal_edges, proposal_weights):
        outer = outer_weights(c, cp, wp)
        loss = loss + torch.mean(torch.clamp_min(w - outer, 0.0) ** 2
                                 / (w + EPS))
    return loss
