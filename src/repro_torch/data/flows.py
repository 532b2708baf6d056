"""CAIDA-like network flow workload (paper §6.1).

The paper joins TCP, UDP and ICMP flow tables (keyed by the src/dst pair) and
asks for the total size of flows present in ALL three.  Real CAIDA counts are
115.5 M / 67.1 M / 2.8 M flows; we scale them down preserving the ratios and
draw flow sizes from a lognormal (the classic heavy-tail of backbone traffic).
Keys are hashed 2-tuples, so a configurable fraction of flow pairs is shared
across the three protocol tables.  The data is made with numpy from
``seed`` (the same draws as the JAX implementation's generator) and placed
on ``device``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.relation import Relation, relation
from repro_torch.data.synthetic import _scramble

CAIDA_RATIOS = (115_472_322, 67_098_852, 2_801_002)


def flow_tables(scale: int = 1 << 14, shared_fraction: float = 0.05,
                seed: int = 0, device="cuda") -> list[Relation]:
    """[tcp, udp, icmp] Relations; value = flow bytes (lognormal).

    ``scale`` = ICMP table size; the others follow CAIDA's ratios.
    ``shared_fraction`` = fraction of each table's flows whose (src, dst)
    pair appears in all three protocols (the join survivors).
    """
    rng = np.random.default_rng(seed)
    sizes = [max(int(scale * r / CAIDA_RATIOS[2]), 8) for r in CAIDA_RATIOS]
    n_shared_keys = max(int(scale * shared_fraction), 1)
    shared = rng.choice(1 << 24, size=n_shared_keys, replace=False)
    rels = []
    for i, size in enumerate(sizes):
        n_shared = int(round(size * shared_fraction))
        own = (1 << 26) * (i + 1) + rng.choice(1 << 24, size=size,
                                               replace=True)
        ks = np.concatenate([rng.choice(shared, size=n_shared),
                             own[: size - n_shared]]).astype(np.uint32)
        ks = _scramble(ks)
        sizes_b = rng.lognormal(mean=7.0, sigma=2.0, size=size)
        vs = np.minimum(sizes_b, 1e9).astype(np.float32)
        perm = rng.permutation(size)
        rels.append(relation(ks[perm], vs[perm], device=device))
    return rels
