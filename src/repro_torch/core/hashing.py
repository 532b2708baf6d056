"""Integer hashing shared by the Bloom sketch, the sampler and the CUDA
kernels (``csrc/hashing.cuh`` holds the same functions for the device).

The hashes are uint32 arithmetic (wrap-around multiply, xor, shift).  PyTorch
has no ``>>`` or ``%`` on ``torch.uint32``, so tensors carry uint32 values in
int64, masked with ``& 0xFFFFFFFF`` after every multiply or add and before
every shift.  An int64 product of two values below 2^32 can wrap past 2^63;
its low 32 bits are still the uint32 product, which is all the mask keeps.

The two primitives are the murmur3 finalizer (``fmix32``) for key hashing and
a counter-based stateless PRNG (``counter_hash``) for the sampler's draws:
``draw = fmix32(seed ^ fmix32(stratum ^ fmix32(counter)))``.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF

# Parquet/Impala split-block Bloom filter salts (8 odd constants, one per
# 32-bit lane of the 256-bit block).
SALT = (
    0x47B6137B,
    0x44974D91,
    0x8824AD5B,
    0xA2B7289D,
    0x705495C7,
    0x2DF1424B,
    0x9EFC4947,
    0x5C6BFB31,
)

GOLDEN = 0x9E3779B1  # 2^32 / phi, odd: cheap secondary mixing.


def u32(x):
    """uint32 value of ``x``: a Python int wraps, a tensor becomes int64."""
    if isinstance(x, (int, np.integer)):
        return int(x) & MASK
    return x.to(torch.int64) & MASK


def fmix32(h):
    """Murmur3 32-bit finalizer: a full-avalanche bijection on uint32."""
    h = u32(h)
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK
    return h ^ (h >> 16)


def hash2(key, seed):
    """Seeded hash: fmix32(key ^ fmix32(seed * GOLDEN))."""
    s = fmix32((u32(seed) * GOLDEN) & MASK)
    return fmix32(u32(key) ^ s)


def counter_hash(seed, stratum, counter, lane):
    """Stateless PRNG draw for (stratum, counter, lane) under ``seed``.

    ``lane`` distinguishes the relation side of the bipartite edge draw
    (0 = left endpoint, 1 = right endpoint, ... for multi-way joins).
    All arguments broadcast.
    """
    h = fmix32(((u32(counter) * GOLDEN) & MASK) + u32(lane))
    h = fmix32(h ^ ((u32(stratum) * 0x85EBCA6B) & MASK))
    return fmix32(h ^ u32(seed))


def bounded(h: torch.Tensor, bound) -> torch.Tensor:
    """Map a uint32 hash into [0, bound) (bound >= 1), as int64.

    Plain modulo; the bias is O(bound / 2^32), negligible for the stratum
    sizes we draw from.
    """
    bound = torch.as_tensor(bound, dtype=torch.int64, device=h.device)
    return h % torch.clamp(bound, min=1)
