"""The benchmark's arithmetic: percentiles, device busy time, the bytes each
kernel's operation must move, and the card's published memory rate.

The byte formulas count each input read once and each output written once
(copied from the program's ``kernels/traffic.py`` so that the yardstick
stays fixed whatever the program does).
"""

from __future__ import annotations

import math

import numpy as np

# NVIDIA H100 SXM5 datasheet: 3.35 TB/s of HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12


def p95(values) -> float | None:
    """The 95th percentile of all ``values`` (linear between order
    statistics), or None when there are none."""
    return float(np.percentile(np.asarray(values, np.float64), 95)) \
        if len(values) else None


def merged(intervals, lo: float, hi: float) -> list:
    """``intervals`` ((start, end) pairs) clipped to [lo, hi] and merged into
    disjoint ones, in order."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi]: overlapping
    device operations count once."""
    return sum(b - a for a, b in merged(intervals, lo, hi))


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that no interval covers, as (start, end)."""
    gaps, t = [], lo
    for a, b in merged(intervals, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def bloom_probe_bytes(B: int, n: int, num_blocks: int) -> int:
    """Keys (int64) of ``B x n`` rows, the ``[B, num_blocks, 8]`` int32
    words, ``B`` seeds (int64), and the bool mask written."""
    return B * n * 8 + B * num_blocks * 32 + B * 8 + B * n


def edge_sample_gathered(n_sampled, counts, joinable) -> float:
    """The value bytes a launch's draws read: per side ``min(draws, count)``
    float32 values of each joinable stratum.  Arrays are numpy, ``[..., S]``."""
    n = np.asarray(n_sampled, np.float64)
    ok = np.asarray(joinable, bool)
    return float(sum(np.minimum(n, np.asarray(c, np.float64))[ok].sum() * 4
                     for c in counts))


def edge_sample_bytes(B: int, S: int, gathered: float) -> float:
    """Per stratum of ``B x S`` its key, two starts and two counts (int64),
    joinable flag (bool) and size (float32); ``B`` seeds (int64); the values
    the draws read; and the three float32 results written."""
    return B * S * (8 + 4 * 8 + 1 + 4) + B * 8 + gathered + B * S * 3 * 4


def roofline_pct(nbytes: float, seconds: float) -> float | None:
    """Share of the memory roofline: the least time the bytes need at the
    card's rate over the time taken, in percent."""
    if seconds <= 0 or not math.isfinite(seconds):
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
