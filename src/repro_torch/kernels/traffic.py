"""The bytes each CUDA kernel must move: each input read once and each
output written once.

One formula a kernel, read by two places: ``chip_smoke.py``'s bound of the
kernel (its bytes over the card's memory rate) and the dry run's byte
meter (``launch/roofline.py``).  The meter's dispatch mode sees the aten
ops of a step but not a kernel launched through ctypes, so each wrapper
hands its launch's bytes to every meter in :data:`METERS` (none outside a
dry run, and then nothing is computed).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._python_dispatch import _disable_current_modes

# the active byte meters: each is called as meter(kernel name, bytes)
METERS: list = []


def bloom_build_bytes(B: int, n: int, num_blocks: int) -> int:
    """Keys (int64) and valid flags (bool) of ``B x n`` rows, ``B`` seeds
    (int64), and the ``[B, num_blocks, 8]`` int32 words written."""
    return B * n * (8 + 1) + B * 8 + B * num_blocks * 32


def bloom_probe_bytes(B: int, n: int, num_blocks: int) -> int:
    """Keys (int64) of ``B x n`` rows, the ``[B, num_blocks, 8]`` int32
    words, ``B`` seeds (int64), and the bool mask written."""
    return B * n * 8 + B * num_blocks * 32 + B * 8 + B * n


def edge_sample_gathered(n_sampled: torch.Tensor, counts, joinable
                         ) -> float:
    """The value bytes a call's draws read: per side, ``min(draws, count)``
    float32 values of each joinable stratum (``counts``: the two sides'
    ``[..., S]`` segment sizes)."""
    return sum(float(torch.minimum(n_sampled, c.float())[joinable].sum()) * 4
               for c in counts)


def edge_sample_bytes(B: int, S: int, gathered: float) -> float:
    """Per stratum of ``B x S`` its key, two starts and two counts (int64),
    joinable flag (bool) and size (float32); ``B`` seeds (int64); the
    values the draws read (``edge_sample_gathered``); and the three float32
    results written."""
    return B * S * (8 + 4 * 8 + 1 + 4) + B * 8 + gathered + B * S * 3 * 4


def record(name: str, nbytes: Callable[[], float]) -> None:
    """Hand one launch's ``nbytes()`` to every active meter (computed only
    when there is one)."""
    if METERS:
        with _disable_current_modes():    # the meters' own ops go unseen
            n = nbytes()
        for meter in METERS:
            meter(name, n)
