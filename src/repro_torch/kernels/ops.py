"""Public wrappers over the three CUDA kernels.

Same contracts as ``repro/kernels/ops.py``: each ``*_batched`` wrapper takes
slot-stacked inputs with a leading batch dimension and a ``[B]`` seed
vector, and the single-query wrappers are its ``B = 1`` case.  The wrappers
make the operands what the kernels take (int64 seeds wrapped mod 2^32,
contiguous per-side slices) and assemble ``BloomFilter`` / ``StratumStats``.
The CUDA kernels mask their own ragged edges, so nothing is padded.

The tensors' device picks the path: CPU tensors go through the plain
PyTorch versions in ``kernels/ref.py``, CUDA tensors launch the kernels.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import bloom
from repro_torch.core.estimators import StratumStats
from repro_torch.core.hashing import MASK
from repro_torch.core.relation import Relation
from repro_torch.core.sampling import Strata
from repro_torch.kernels.bloom_build import bloom_build_batched
from repro_torch.kernels.bloom_probe import bloom_probe_batched
from repro_torch.kernels.edge_sample import edge_sample_batched


def _seeds(seeds, device) -> torch.Tensor:
    """Seeds -> int64 ``[B]`` on ``device``, each wrapped mod 2^32."""
    if isinstance(seeds, (int, np.integer)):
        seeds = [seeds]
    if not isinstance(seeds, torch.Tensor):
        seeds = torch.tensor([int(s) & MASK for s in seeds])
    return (seeds.to(device=device, dtype=torch.int64) & MASK).reshape(-1)


# ---------------------------------------------------------------------------
# Filter build
# ---------------------------------------------------------------------------

def build_filter_batched(keys: torch.Tensor, valid: torch.Tensor,
                         num_blocks: int, seeds) -> torch.Tensor:
    """Per-slot bloom build: packed words int32 ``[B, nb, 8]``.

    ``keys``/``valid`` are slot-stacked ``[B, N]``; ``seeds`` ``[B]``.
    """
    return bloom_build_batched(keys.contiguous(), valid.contiguous(),
                               num_blocks, _seeds(seeds, keys.device))


def build_filter(keys: torch.Tensor, valid: torch.Tensor, num_blocks: int,
                 seed=0) -> bloom.BloomFilter:
    """Kernel-backed ``bloom.build`` (B = 1)."""
    words = build_filter_batched(keys[None], valid[None], num_blocks,
                                 _seeds(seed, keys.device))[0]
    return bloom.BloomFilter(words, seed)


# ---------------------------------------------------------------------------
# Filter probe
# ---------------------------------------------------------------------------

def probe_filter_batched(words: torch.Tensor, keys: torch.Tensor,
                         seeds) -> torch.Tensor:
    """Per-slot membership probe: bool ``[B, N]``.

    ``words`` is the stacked ``[B, nb, 8]`` filter layout (each slot probes
    its OWN filter), keys ``[B, N]``, ``seeds`` ``[B]``.
    """
    return bloom_probe_batched(words.contiguous(), keys.contiguous(),
                               _seeds(seeds, keys.device))


def probe_filter(words: torch.Tensor, keys: torch.Tensor,
                 seed=0) -> torch.Tensor:
    """Kernel-backed ``bloom.contains`` (B = 1)."""
    return probe_filter_batched(words[None], keys[None],
                                _seeds(seed, keys.device))[0]


# ---------------------------------------------------------------------------
# Fused edge sampler
# ---------------------------------------------------------------------------

def sample_stats_batched(values1: torch.Tensor, values2: torch.Tensor,
                         strata_keys: torch.Tensor,
                         starts: torch.Tensor, counts: torch.Tensor,
                         joinable: torch.Tensor, population: torch.Tensor,
                         b_i: torch.Tensor, seeds, b_max: int,
                         expr: str = "sum") -> StratumStats:
    """Per-slot Algorithm-2 pass: StratumStats with ``[B, S]`` leaves.
    ``starts``/``counts`` are ``[B, 2, S]``; ``seeds`` ``[B]``."""
    c = torch.Tensor.contiguous
    n, sf, sf2 = edge_sample_batched(
        c(values1), c(values2), c(strata_keys),
        c(starts[:, 0]), c(counts[:, 0]), c(starts[:, 1]), c(counts[:, 1]),
        c(joinable), c(b_i.to(torch.float32)),
        _seeds(seeds, strata_keys.device), b_max, expr)
    return StratumStats(valid=joinable, population=population,
                        n_sampled=n, sum_f=sf, sum_f2=sf2)


def sample_stats_2way(values1: torch.Tensor, values2: torch.Tensor,
                      strata_keys: torch.Tensor,
                      starts: torch.Tensor, counts: torch.Tensor,
                      joinable: torch.Tensor, population: torch.Tensor,
                      b_i: torch.Tensor, b_max: int, seed=0,
                      expr: str = "sum") -> StratumStats:
    """Two-way Algorithm-2 pass returning StratumStats (B = 1)."""
    stats = sample_stats_batched(
        values1[None], values2[None], strata_keys[None], starts[None],
        counts[None], joinable[None], population[None], b_i[None],
        _seeds(seed, strata_keys.device), b_max, expr)
    return StratumStats(*(x[0] for x in stats))


def sample_stats(sorted_rels: Sequence[Relation], strata: Strata,
                 b_i: torch.Tensor, b_max: int, seed=0,
                 expr: str = "sum") -> StratumStats:
    """Strata-level entry point (two-way only)."""
    if len(sorted_rels) != 2:
        raise ValueError("the kernel sampler is two-way; use core.sampling")
    return sample_stats_2way(
        sorted_rels[0].values, sorted_rels[1].values,
        strata.keys, strata.starts, strata.counts,
        strata.joinable, strata.population,
        b_i, b_max, seed, expr)
