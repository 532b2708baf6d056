"""Synthetic join workloads (paper §5.1).

The paper's microbenchmarks use Poisson-valued tuples with lambda in
[10, 10000], a controlled *overlap fraction* (share of tuples participating
in the join), and key counts proportional to the worker count.

``overlapping_relations`` constructs n datasets where exactly the requested
fraction of tuples carries keys drawn from a pool shared by ALL inputs (so
they survive an n-way join filter) and the rest carries per-dataset exclusive
keys.  Keys are scrambled through fmix32 so they spread uniformly.  The data
is made with numpy from ``seed`` (the same draws as the JAX implementation's
generator) and placed on ``device``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.relation import Relation, relation

# key-space layout: [0, _POOL_SPAN) shared pool, then per-dataset pools.
_POOL_SPAN = 1 << 20


def _scramble(keys: np.ndarray) -> np.ndarray:
    """numpy murmur3 finalizer (matches core.hashing.fmix32 bit for bit)."""
    h = keys.astype(np.uint64)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & np.uint64(0xFFFFFFFF)
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & np.uint64(0xFFFFFFFF)
    h ^= h >> np.uint64(16)
    return h.astype(np.uint32)


def overlapping_relations(sizes, overlap_fraction: float,
                          keys_per_dataset: int = 1024,
                          lam: float = 10.0,
                          seed: int = 0,
                          scramble: bool = True,
                          device="cuda") -> list[Relation]:
    """n relations with the given overlap fraction and Poisson(lam) values."""
    rng = np.random.default_rng(seed)
    shared_keys = rng.choice(_POOL_SPAN, size=max(
        int(keys_per_dataset * overlap_fraction), 1), replace=False)
    rels = []
    for i, size in enumerate(sizes):
        n_shared = int(round(size * overlap_fraction))
        own_pool = (i + 1) * _POOL_SPAN
        own_keys = own_pool + rng.choice(
            _POOL_SPAN, size=max(keys_per_dataset - len(shared_keys), 1),
            replace=False)
        ks = np.concatenate([
            rng.choice(shared_keys, size=n_shared),
            rng.choice(own_keys, size=size - n_shared),
        ]).astype(np.uint32)
        if scramble:
            ks = _scramble(ks)
        vs = rng.poisson(lam, size=size).astype(np.float32)
        perm = rng.permutation(size)
        rels.append(relation(ks[perm], vs[perm], device=device))
    return rels


def skewed_relation(size: int, num_keys: int, zipf_a: float = 1.5,
                    lam: float = 10.0, seed: int = 0,
                    device="cuda") -> Relation:
    """Zipf-skewed key distribution (stress for the stratified sampler)."""
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(zipf_a, size=size), num_keys) - 1
    ks = _scramble(ranks.astype(np.uint32))
    vs = rng.poisson(lam, size=size).astype(np.float32)
    return relation(ks, vs, device=device)
