"""Plain PyTorch versions of the three CUDA kernels.

Same contracts as the kernels (and as ``repro/kernels/ref.py``, plus a
leading slot dimension): each slot ``b`` has its own seed ``seeds[b]``.  They
run on any device and use the same hash functions as the rest of the port,
so the CPU tests hold them against the JAX kernels and the card tests hold
the CUDA kernels against them.
"""

from __future__ import annotations

import torch

from repro_torch.core import bloom
from repro_torch.core.hashing import MASK, bounded, counter_hash


def bloom_hashes_ref(keys: torch.Tensor, num_blocks: int, seeds: torch.Tensor):
    """(block index int64 [B, N], lane masks int64 [B, N, 8]) per key."""
    s = seeds[:, None]
    return bloom.block_index(keys, num_blocks, s), bloom.lane_masks(keys, s)


def bloom_build_ref(keys: torch.Tensor, valid: torch.Tensor, num_blocks: int,
                    seeds: torch.Tensor) -> torch.Tensor:
    """Packed filter words int32 [B, num_blocks, 8] over each slot's valid
    keys: the hashes plus ``bloom.scatter_or``."""
    blk, masks = bloom_hashes_ref(keys, num_blocks, seeds)
    return torch.stack([bloom.scatter_or(blk[b], masks[b], valid[b],
                                         num_blocks).words
                        for b in range(keys.shape[0])])


def bloom_probe_ref(words: torch.Tensor, keys: torch.Tensor,
                    seeds: torch.Tensor) -> torch.Tensor:
    """Membership mask bool [B, N]: each slot's keys against its own filter
    ``words[b]`` ([B, num_blocks, 8])."""
    blk, masks = bloom_hashes_ref(keys, words.shape[1], seeds)
    slot = torch.arange(keys.shape[0], device=keys.device)[:, None]
    gathered = words[slot, blk].to(torch.int64) & MASK       # [B, N, 8]
    return torch.all((gathered & masks) == masks, dim=-1)


def edge_sample_ref(values1: torch.Tensor, values2: torch.Tensor,
                    keys: torch.Tensor,
                    start1: torch.Tensor, count1: torch.Tensor,
                    start2: torch.Tensor, count2: torch.Tensor,
                    joinable: torch.Tensor, b_i: torch.Tensor,
                    b_max: int, seeds: torch.Tensor, expr: str = "sum"):
    """Two-way Algorithm-2 sampler: per-slot per-stratum (n, sum_f, sum_f2),
    float32 [B, S] each.

    Materializes the [B, S, b_max] draw grid (what the kernel avoids), same
    math, same hashes.  A stratum absent from a side has its start at that
    side's end; its draws are masked, and the clamp keeps their gathers in
    bounds.
    """
    B, S = keys.shape
    t = torch.arange(b_max, device=keys.device)[None, None, :]
    k = keys[..., None]
    s = seeds[:, None, None]
    vals = []
    for side, (v, start, count) in enumerate(
            ((values1, start1, count1), (values2, start2, count2))):
        h = counter_hash(s, k, t, side)                       # [B, S, b_max]
        i = start[..., None] + bounded(h, torch.clamp(count, min=1)[..., None])
        i = torch.clamp(i, max=v.shape[1] - 1).reshape(B, -1)
        vals.append(torch.gather(v, 1, i).reshape(B, S, b_max))
    fv = vals[0] * vals[1] if expr == "product" else vals[0] + vals[1]
    tm = torch.arange(b_max, dtype=torch.float32, device=keys.device)
    mask = (tm < b_i.to(torch.float32)[..., None]) & joinable[..., None]
    fm = torch.where(mask, fv, 0.0)
    return (mask.sum(-1, dtype=torch.float32), fm.sum(-1), (fm * fm).sum(-1))
