"""Spatial hashing of the multiresolution hash grid (ops/hashing.py of the
JAX package, a copy: the JAX module imports jax).

The hash is the Instant-NGP XOR-of-primes hash

    h(x, y, z) = (x * 1) ^ (y * 2654435761) ^ (z * 805459861)  mod 2^T

The JAX package computes it in uint32, whose arithmetic PyTorch lacks on
CUDA. Here it runs in int64 and is masked: only the low ``T < 32`` bits
survive the mask, and the low 32 bits of a product, of an XOR and of a
two's-complement negative are the same in mod-2^64 and mod-2^32
arithmetic, so the result equals the JAX uint32 one bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

# The 8 corners of a unit voxel; corner c has bits (c >> 2 & 1, c >> 1 & 1,
# c & 1) on (x, y, z): 0 -> 000, 1 -> 001, ..., 7 -> 111.
BOX_OFFSETS = np.array(
    [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)], dtype=np.int32
)

# The first 7 primes of the Instant-NGP hash.
PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
          2165219737)


def spatial_hash(coords: torch.Tensor, log2_hashmap_size: int) -> torch.Tensor:
    """XOR-of-primes hash of integer grid coordinates ``[..., D]`` (``D <=
    7``) -> int64 ``[...]`` table indices in ``[0, 2^log2_hashmap_size)``."""
    d = coords.shape[-1]
    if d > len(PRIMES):
        raise ValueError(f"spatial_hash supports up to {len(PRIMES)} dims, got {d}")
    c = coords.to(torch.int64)
    out = c[..., 0] * PRIMES[0]
    for i in range(1, d):
        out = out ^ (c[..., i] * PRIMES[i])
    return out & ((1 << log2_hashmap_size) - 1)
