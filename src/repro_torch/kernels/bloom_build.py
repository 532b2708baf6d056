"""CUDA kernel: Bloom filter build, hash and commit in one pass
(``csrc/bloom_build.cu``).

Replaces the TPU kernel ``repro/kernels/bloom_build.py`` (``_kernel`` /
``bloom_hashes_batched``) together with the ``bloom.scatter_or`` commit its
wrapper runs: TPU Pallas has no scatter atomics, Hopper does.

What held it back: the first Hopper version issued 8 32-bit ``atomicOr``
per valid key, 134 M atomics for 2^24 keys, 1.6622 ms on an H100 80GB HBM3
at 700 W (about 30x its byte bound): on the paper's microbenchmark each key
repeats about 256 times, so the atomics queued on a few L2 words, and
nearly all of them changed nothing.

The kernel now reads each key's block (from L2, as the words change during
the kernel) before any atomic, and commits only the bits the block lacks,
with one 64-bit ``atomicOr`` per pair of lanes: at most 4 atomics per key,
none once a key's bits are set.  Two threads share each key, each reading
and committing one 16-byte half of its block, so a warp load asks for 16
whole sectors; each thread has 4 keys' reads in flight, and the seed is
mixed once per block.  What bounds it: bytes (9 per key, the 32-byte words
once); the integer operations a key needs (hash, masks, the OR of its bits)
take less time at the card's integer rates, and atomics are not in the
bound (``chip_smoke.py`` computes both terms).  OR does not depend on
order, so the words equal the plain version's bit for bit.

The plain version is :func:`repro_torch.kernels.ref.bloom_build_ref`; a CPU
tensor takes it, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, traffic
from repro_torch.kernels.ref import bloom_build_ref, bloom_hashes_ref

__all__ = ["bloom_build_batched", "bloom_hashes_batched", "bloom_build_ref",
           "bloom_hashes_ref"]


def _check_common(name, keys, seeds, num_blocks):
    B, n = keys.shape
    dev = keys.device
    _build.require(name, keys, torch.int64, (B, n), dev)
    _build.require(name, seeds, torch.int64, (B,), dev)
    if num_blocks < 1 or num_blocks & (num_blocks - 1):
        raise ValueError(f"{name}: num_blocks {num_blocks} is not a power of 2")
    if B > 65535:
        raise ValueError(f"{name}: at most 65535 slots, got {B}")
    return B, n, dev


def bloom_build_batched(keys: torch.Tensor, valid: torch.Tensor,
                        num_blocks: int, seeds: torch.Tensor) -> torch.Tensor:
    """Packed filter words int32 ``[B, num_blocks, 8]`` over each slot's
    valid keys.  ``keys`` int64 / ``valid`` bool ``[B, N]``, ``seeds`` int64
    ``[B]``, all on one device."""
    if not keys.is_cuda:
        return bloom_build_ref(keys, valid, num_blocks, seeds)
    B, n, dev = _check_common("bloom_build", keys, seeds, num_blocks)
    _build.require("bloom_build", valid, torch.bool, (B, n), dev)
    words = torch.zeros((B, num_blocks, 8), dtype=torch.int32, device=dev)
    if B * n == 0:
        return words
    # lanes are committed in pairs, as 8-byte words
    _build.require_aligned("bloom_build", "words", words, 32)
    fn = _build.function("bloom_build", "bloom_build", "ppppiiip")
    with torch.cuda.device(dev):
        rc = fn(keys.data_ptr(), valid.data_ptr(), seeds.data_ptr(),
                words.data_ptr(), B, n, num_blocks, _build.stream(dev))
    bloom_build_batched.launches += 1
    traffic.record("bloom_build",
                   lambda: traffic.bloom_build_bytes(B, n, num_blocks))
    _build.check(rc, "bloom_build")
    return words


bloom_build_batched.launches = 0


def bloom_hashes_batched(keys: torch.Tensor, seeds: torch.Tensor,
                         num_blocks: int):
    """(block index int64 ``[B, N]``, lane masks int64 ``[B, N, 8]``): the
    hash half of the build alone, without the commit."""
    if not keys.is_cuda:
        return bloom_hashes_ref(keys, num_blocks, seeds)
    B, n, dev = _check_common("bloom_hashes", keys, seeds, num_blocks)
    blk = torch.empty((B, n), dtype=torch.int64, device=dev)
    masks = torch.empty((B, n, 8), dtype=torch.int64, device=dev)
    if B * n == 0:
        return blk, masks
    fn = _build.function("bloom_build", "bloom_hashes", "ppppiiip")
    with torch.cuda.device(dev):
        rc = fn(keys.data_ptr(), seeds.data_ptr(), blk.data_ptr(),
                masks.data_ptr(), B, n, num_blocks, _build.stream(dev))
    bloom_hashes_batched.launches += 1
    _build.check(rc, "bloom_hashes")
    return blk, masks


bloom_hashes_batched.launches = 0
