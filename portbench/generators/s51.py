"""The paper's §5.1 microbenchmark data.

A pool of ``keys_per_dataset * overlap_fraction`` keys is shared by every
input; each input draws ``round(rows * overlap_fraction)`` rows' keys from it
and the rest from ``keys_per_dataset`` minus that many keys of its own, all
keys scrambled by fmix32 (so they spread uniformly), values
Poisson(``poisson_lambda``), rows in random order.
"""

from __future__ import annotations

import torch

from portbench.generators import generator
from portbench.reference.join import MASK, fmix32

# key-space layout: [0, POOL) shared, then one pool per input
POOL = 1 << 20


def generate(cfg: dict, seed: int, device) -> list:
    g = generator(seed, device)
    frac, n_keys = cfg["overlap_fraction"], cfg["keys_per_dataset"]
    shared = torch.randperm(POOL, generator=g, device=device)[
        :max(int(n_keys * frac), 1)]
    rels = []
    for i, size in enumerate(cfg["rows"]):
        own = (i + 1) * POOL + torch.randperm(POOL, generator=g,
                                              device=device)[
            :max(n_keys - shared.shape[0], 1)]
        pools = [fmix32(p) for p in (shared, own)]
        if any(bool((p == MASK).any()) for p in pools):
            raise ValueError("s51: a scrambled key is the reserved 0xFFFFFFFF")
        n_shared = int(round(size * frac))
        keys = torch.cat([
            pools[0][torch.randint(pools[0].shape[0], (n_shared,),
                                   generator=g, device=device)],
            pools[1][torch.randint(pools[1].shape[0], (size - n_shared,),
                                   generator=g, device=device)]])
        values = torch.poisson(torch.full(
            (size,), float(cfg["poisson_lambda"]), device=device), generator=g)
        perm = torch.randperm(size, generator=g, device=device)
        rels.append((keys[perm], values[perm]))
    return rels
