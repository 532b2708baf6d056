"""CUDA kernel: join-filter membership probe (``csrc/bloom_probe.cu``).

Replaces the TPU kernel ``repro/kernels/bloom_probe.py`` (``_kernel`` /
``bloom_probe_batched``).  Every tuple of every input probes the join filter
once (§3.1).  One thread per (slot, key) hashes the key under its slot's
seed (mixed once per block), loads its 32-byte block as two 16-byte loads
and compares the 8 lane bits; each slot probes its own filter.

What bounds it on the card: bytes, 8 per key read, 1 per key written, plus
the 32-byte words once; its integer operations take less time at the
card's integer rates (``chip_smoke.py`` computes both).  More keys in
flight did not make it faster on the paper's microbenchmark: 4 keys a
thread, or two threads a key with 4 or 8 keys each, all took 0.17-0.21 ms
for 2^24 keys on an H100 80GB HBM3 at 700 W, as this design does (see
PERF.md).  The TPU kernel pins the stacked filters in VMEM and asserts they
fit in 8 MiB; a Hopper block has 227 KB of shared memory and the join filter
at 2^24 keys is 32 MiB, so the kernel reads it through L1 and the 50 MB L2
instead, and has no size limit of its own.  ``words`` must be 32-byte
aligned, so that each block is one sector.

The plain version is :func:`repro_torch.kernels.ref.bloom_probe_ref`; a CPU
tensor takes it, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bloom_probe_ref

__all__ = ["bloom_probe_batched", "bloom_probe_ref"]


def bloom_probe_batched(words: torch.Tensor, keys: torch.Tensor,
                        seeds: torch.Tensor) -> torch.Tensor:
    """Membership mask bool ``[B, N]``: slot ``b``'s keys against its own
    filter ``words[b]`` (int32 ``[B, num_blocks, 8]``).  ``keys`` int64
    ``[B, N]``, ``seeds`` int64 ``[B]``."""
    if not keys.is_cuda:
        return bloom_probe_ref(words, keys, seeds)
    B, n = keys.shape
    nb = words.shape[1]
    dev = keys.device
    _build.require("bloom_probe", words, torch.int32, (B, nb, 8), dev)
    _build.require("bloom_probe", keys, torch.int64, (B, n), dev)
    _build.require("bloom_probe", seeds, torch.int64, (B,), dev)
    if nb < 1 or nb & (nb - 1):
        raise ValueError(f"bloom_probe: num_blocks {nb} is not a power of 2")
    if B > 65535:
        raise ValueError(f"bloom_probe: at most 65535 slots, got {B}")
    _build.require_aligned("bloom_probe", "words", words, 32)
    out = torch.empty((B, n), dtype=torch.bool, device=dev)
    if B * n == 0:
        return out
    fn = _build.function("bloom_probe", "bloom_probe", "ppppiiip")
    with torch.cuda.device(dev):
        rc = fn(words.data_ptr(), keys.data_ptr(), seeds.data_ptr(),
                out.data_ptr(), B, n, nb, _build.stream(dev))
    bloom_probe_batched.launches += 1
    _build.check(rc, "bloom_probe")
    return out


bloom_probe_batched.launches = 0
