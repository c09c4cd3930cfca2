"""The server's copy of a request's maps off the card (marker ``cuda``;
skipped without one).

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_serve_cuda.py

This file imports no jax, so it runs where the card is.
"""

import numpy as np
import pytest
import torch

from indoor_nerf_tpu_torch.render.renderer import MAP_KEYS
from indoor_nerf_tpu_torch.serve import maps_to_host

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the copy is to page-locked memory)")


def test_maps_to_host_gives_each_request_arrays_of_its_own():
    """Page-locked copies equal the pageable ones, bit for bit, and the
    arrays of one request outlive the next request's copy unchanged (a
    block returns to the host allocator's cache only once it is dropped)."""
    _need_card()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def maps():
        out = {"rgb_map": torch.rand(96, 80, 3, generator=g, device=dev)}
        out.update({k: torch.rand(96, 80, generator=g, device=dev)
                    for k in MAP_KEYS[1:]})
        # A non-contiguous map, as a reshaped tile concatenation can be.
        out["depth_map"] = out["depth_map"].t().contiguous().t()
        return out

    first, second = maps(), maps()
    a = maps_to_host(first, dev)
    want = {k: first[k].cpu().numpy().copy() for k in MAP_KEYS}
    b = maps_to_host(second, dev)
    for k in MAP_KEYS:
        assert a[k].shape == tuple(first[k].shape)
        np.testing.assert_array_equal(a[k], want[k])
        np.testing.assert_array_equal(b[k], second[k].cpu().numpy())
        assert not np.shares_memory(a[k], b[k])
    del a
    c = maps_to_host(first, dev)  # may reuse the blocks ``a`` dropped
    for k in MAP_KEYS:
        np.testing.assert_array_equal(b[k], second[k].cpu().numpy())
        np.testing.assert_array_equal(c[k], want[k])
