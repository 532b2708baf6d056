"""Split-block Bloom filters (the paper's sketch, §3.1).

A key selects one 256-bit block (8 x 32-bit lanes) and sets exactly one bit
in each lane, chosen by eight per-lane salted hashes (the Parquet/Impala
split-block layout).  Partition filters merge with OR, dataset filters with
AND (Algorithm 1), which are plain ``|`` / ``&`` on the packed words.

Sizing uses the paper's Eq. 27, |BF| = -N ln p / (ln 2)^2 bits, rounded up to
a power-of-two number of blocks.

Words are int32 tensors ``[num_blocks, 8]`` holding the uint32 bit patterns
(int32 has every bitwise op on every device; the CUDA kernels read the same
bytes as ``uint32_t``).  Block indices and lane masks are int64, like keys.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.hashing import MASK, SALT, fmix32, hash2

WORDS_PER_BLOCK = 8
BITS_PER_BLOCK = 32 * WORDS_PER_BLOCK

# keys per pass of the plain scatter-OR: bounds its [chunk, 8, 32] unpacked
# cell indices to 512 MiB of int64 whatever the relation's size
_SCATTER_CHUNK = 1 << 18


class BloomFilter(NamedTuple):
    """Packed split-block Bloom filter: int32 words [num_blocks, 8]."""

    words: torch.Tensor
    seed: int = 0

    @property
    def num_blocks(self) -> int:
        return self.words.shape[-2]

    @property
    def num_bits(self) -> int:
        return self.num_blocks * BITS_PER_BLOCK

    @property
    def size_bytes(self) -> int:
        return self.num_bits // 8

    @classmethod
    def from_numpy(cls, words: np.ndarray, seed: int = 0,
                   device="cuda") -> "BloomFilter":
        """Load uint32 filter words (e.g. cached by the JAX implementation)."""
        arr = np.array(words, np.uint32).view(np.int32)  # a writable copy
        return cls(torch.as_tensor(arr, device=device), seed)

    def to_numpy(self) -> np.ndarray:
        """The words as a uint32 host array."""
        return self.words.cpu().numpy().view(np.uint32)


def num_blocks_for(n_keys: int, fp_rate: float) -> int:
    """Paper Eq. 27 sizing, rounded up to a power-of-two block count."""
    n_keys = max(int(n_keys), 1)
    bits = -n_keys * math.log(max(min(fp_rate, 0.5), 1e-12)) / (math.log(2) ** 2)
    blocks = max(1, math.ceil(bits / BITS_PER_BLOCK))
    return 1 << (blocks - 1).bit_length()


def block_index(keys: torch.Tensor, num_blocks: int, seed) -> torch.Tensor:
    """Which block each key lands in (num_blocks must be a power of two)."""
    return hash2(keys, seed) & (num_blocks - 1)


def lane_masks(keys: torch.Tensor, seed) -> torch.Tensor:
    """[..., 8] int64: the one-bit-per-lane masks for each key."""
    h = fmix32(((hash2(keys, seed) * 0x85EBCA6B) & MASK) + 1)
    # bit position in lane = top 5 bits of (h * salt)
    return torch.stack([1 << (((h * s) & MASK) >> 27) for s in SALT], dim=-1)


def empty(num_blocks: int, seed: int = 0, device="cuda") -> BloomFilter:
    return BloomFilter(torch.zeros((num_blocks, WORDS_PER_BLOCK),
                                   dtype=torch.int32, device=device), seed)


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 tensor of the same bit pattern."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def scatter_or(blk: torch.Tensor, masks: torch.Tensor, valid: torch.Tensor,
               num_blocks: int, seed: int = 0) -> BloomFilter:
    """Scatter-OR (block, mask) pairs into a packed filter.

    An unpacked scatter-max over bits (a ``[num_blocks + 1, 8, 32]`` uint8
    grid whose last row takes the invalid keys and is cut off), packed once
    at the end.  The CUDA build kernel does the same with ``atomicOr``.
    """
    cells = torch.zeros((num_blocks + 1) * BITS_PER_BLOCK, dtype=torch.uint8,
                        device=blk.device)
    shifts = torch.arange(32, device=blk.device)
    lane_base = (torch.arange(WORDS_PER_BLOCK, device=blk.device) * 32)[:, None]
    blk = torch.where(valid, blk, num_blocks)
    for lo in range(0, blk.shape[0], _SCATTER_CHUNK):
        b = blk[lo:lo + _SCATTER_CHUNK]
        bits = ((masks[lo:lo + _SCATTER_CHUNK, :, None] >> shifts) & 1).bool()
        cell = b[:, None, None] * BITS_PER_BLOCK + lane_base + shifts
        # the max of {0, 1} bits over a zeroed grid: write the set ones
        cells[cell[bits]] = 1
    return BloomFilter(_pack(cells[:num_blocks * BITS_PER_BLOCK].view(
        num_blocks, WORDS_PER_BLOCK, 32)), seed)


def build(keys: torch.Tensor, valid: torch.Tensor, num_blocks: int,
          seed: int = 0) -> BloomFilter:
    """Build a filter over the valid keys (plain PyTorch path)."""
    return scatter_or(block_index(keys, num_blocks, seed),
                      lane_masks(keys, seed), valid, num_blocks, seed)


def contains(f: BloomFilter, keys: torch.Tensor) -> torch.Tensor:
    """Membership probe (plain PyTorch path; the hot path has a kernel)."""
    blk = block_index(keys, f.num_blocks, f.seed)
    masks = lane_masks(keys, f.seed)
    gathered = f.words[blk].to(torch.int64) & MASK  # [N, 8]
    return torch.all((gathered & masks) == masks, dim=-1)


def union(a: BloomFilter, b: BloomFilter) -> BloomFilter:
    """OR-merge (partition filters -> dataset filter)."""
    _check_compatible(a, b)
    return BloomFilter(a.words | b.words, a.seed)


def intersect(a: BloomFilter, b: BloomFilter) -> BloomFilter:
    """AND-merge (dataset filters -> join filter).

    As in the paper, the AND of Bloom filters is a filter whose set is a
    superset of the intersection of the sets (false positives possible, false
    negatives not).
    """
    _check_compatible(a, b)
    return BloomFilter(a.words & b.words, a.seed)


def _check_compatible(a: BloomFilter, b: BloomFilter, i: int = 1) -> None:
    if b.words.shape != a.words.shape:
        raise ValueError(
            f"filter {i} words shape {tuple(b.words.shape)} != filter 0 shape "
            f"{tuple(a.words.shape)} (num_blocks mismatch)")
    if (isinstance(a.seed, int) and isinstance(b.seed, int)
            and a.seed != b.seed):
        raise ValueError(f"filter {i} seed {b.seed} != filter 0 seed "
                         f"{a.seed}: filters hash incompatibly")


def intersect_all(filters: list[BloomFilter]) -> BloomFilter:
    """AND-merge n dataset filters into the join filter (§3.1, Alg. 1).

    Validates that the filters agree before merging: intersecting filters
    with different geometry or hash seeds silently returns garbage.  Seeds
    are compared only when both are Python ints (a batch carries a tensor of
    per-slot seeds, and its caller passes the same tensor to every filter).
    """
    filters = list(filters)
    if not filters:
        raise ValueError("intersect_all: need at least one filter")
    first = filters[0]
    words = first.words
    for i, f in enumerate(filters[1:], start=1):
        _check_compatible(first, f, i)
        words = words & f.words
    return BloomFilter(words, first.seed)


def _unpack(words: torch.Tensor) -> torch.Tensor:
    """uint32 bit patterns [..., W] -> uint8 bits [..., W, 32]."""
    shifts = torch.arange(32, device=words.device)
    w = words.to(torch.int64) & MASK
    return ((w[..., None] >> shifts) & 1).to(torch.uint8)


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """uint8 bits [..., W, 32] -> int32 words [..., W] (uint32 patterns)."""
    shifts = torch.arange(32, device=bits.device)
    return to_int32((bits.to(torch.int64) << shifts).sum(-1))


def fill_fraction(f: BloomFilter) -> torch.Tensor:
    """Fraction of set bits (sanity metric; ~0.5 at design load)."""
    return _unpack(f.words).to(torch.float32).mean()


# ---------------------------------------------------------------------------
# Appendix-B variants: size models + a functional counting filter.
# ---------------------------------------------------------------------------

def flat_filter_bits(n_keys: int, fp_rate: float) -> int:
    """Regular Bloom filter size (paper Eq. 27), in bits."""
    n_keys = max(int(n_keys), 1)
    return math.ceil(-n_keys * math.log(fp_rate) / (math.log(2) ** 2))


def counting_filter_bits(n_keys: int, fp_rate: float, counter_bits: int = 4) -> int:
    """Counting BF: a ``counter_bits`` counter per cell instead of one bit."""
    return flat_filter_bits(n_keys, fp_rate) * counter_bits


def invertible_filter_bits(n_keys: int, fp_rate: float,
                           key_bits: int = 32, count_bits: int = 32) -> int:
    """IBF: each cell stores (count, keySum, hashSum), modeled per [26]."""
    cells = flat_filter_bits(n_keys, fp_rate) // 8
    cells = max(cells, int(1.3 * n_keys))
    return cells * (count_bits + key_bits + key_bits)


def scalable_filter_bits(n_keys: int, fp_rate: float, initial: int = 4096,
                         growth: int = 2, tightening: float = 0.9) -> int:
    """SBF [41]: series of filters of growing size / tightening error."""
    total, cap, err, added = 0, initial, fp_rate * (1 - tightening), 0
    while added < n_keys:
        total += flat_filter_bits(cap, err)
        added += cap
        cap *= growth
        err *= tightening
    return total


class CountingFilter(NamedTuple):
    """Functional counting Bloom filter (supports remove), Appendix B-II."""

    counts: torch.Tensor  # int32 [num_blocks, 8, 32] (unpacked cells)
    seed: int = 0

    @property
    def num_blocks(self) -> int:
        return self.counts.shape[0]


def counting_empty(num_blocks: int, seed: int = 0,
                   device="cuda") -> CountingFilter:
    return CountingFilter(torch.zeros((num_blocks, WORDS_PER_BLOCK, 32),
                                      dtype=torch.int32, device=device), seed)


def counting_add(f: CountingFilter, keys: torch.Tensor, valid: torch.Tensor,
                 sign: int = 1) -> CountingFilter:
    """Add (``sign=1``) or remove (``sign=-1``) the valid keys: an integer
    scatter-add of their unpacked lane bits (exact in any order)."""
    blk = torch.where(valid, block_index(keys, f.num_blocks, f.seed),
                      f.num_blocks)               # overflow row is dropped
    bits = _unpack(lane_masks(keys, f.seed)).to(torch.int32) * sign
    grid = torch.zeros((f.num_blocks + 1,) + tuple(f.counts.shape[1:]),
                       dtype=torch.int32, device=f.counts.device)
    grid.index_add_(0, blk, bits)
    return CountingFilter(f.counts + grid[:f.num_blocks], f.seed)


def counting_contains(f: CountingFilter, keys: torch.Tensor) -> torch.Tensor:
    packed = BloomFilter(_pack((f.counts > 0).to(torch.uint8)), f.seed)
    return contains(packed, keys)


def false_positive_rate(num_blocks: int, n_keys: int) -> float:
    """Predicted FPR of the split-block filter at load n_keys.

    Per-lane analysis: each lane of a block holding ``c`` keys has FPR
    1-(1-1/32)^c; block FPR = prod over 8 lanes; averaged over the Poisson
    block-occupancy distribution (numpy, used for sizing sanity checks).
    """
    lam = n_keys / num_blocks
    cs = np.arange(0, max(int(lam * 8), 16) + 1)
    # log-space Poisson pmf (factorials overflow past ~170)
    logpmf = -lam + cs * np.log(max(lam, 1e-12)) \
        - np.array([math.lgamma(int(c) + 1) for c in cs])
    pois = np.exp(logpmf)
    per_lane = 1.0 - (1.0 - 1.0 / 32.0) ** cs
    return float(np.sum(pois * per_lane ** WORDS_PER_BLOCK))


# ---------------------------------------------------------------------------
# Appendix B-III: functional Scalable Bloom Filter with the UNION operation
# (the merge the paper contributed upstream: "SBFs contain a set of regular
# Bloom filters, so union two SBFs by unioning the stages pairwise").
# ---------------------------------------------------------------------------

class ScalableFilter:
    """Host-managed SBF: a list of split-block stages of doubling capacity
    and tightening error; ``add`` spills to a fresh stage when the current
    one reaches its design load.  Tensors on ``device`` inside, Python
    growth control (the structure is data-dependent, which is why the
    serving path uses fixed-size filters: this variant serves ad-hoc
    driver-side use)."""

    def __init__(self, initial_capacity: int = 4096, fp_rate: float = 0.01,
                 growth: int = 2, tightening: float = 0.5, seed: int = 0,
                 device="cuda"):
        self.growth = growth
        self.tightening = tightening
        self.seed = seed
        self.device = torch.device(device)
        self.stages: list[BloomFilter] = []
        self.caps: list[int] = []
        self.errs: list[float] = []
        self.counts: list[int] = []
        self._next_cap = initial_capacity
        self._next_err = fp_rate * (1 - tightening)

    def _keys(self, keys) -> torch.Tensor:
        """Array-like uint32 keys -> int64 tensor on the filter's device."""
        if isinstance(keys, torch.Tensor):
            return (keys.to(self.device, torch.int64) & MASK).reshape(-1)
        arr = np.asarray(keys).reshape(-1).astype(np.uint32).astype(np.int64)
        return torch.as_tensor(arr, device=self.device)

    def _push_stage(self) -> None:
        nb = num_blocks_for(self._next_cap, self._next_err)
        self.stages.append(empty(nb, self.seed, self.device))
        self.caps.append(self._next_cap)
        self.errs.append(self._next_err)
        self.counts.append(0)
        self._next_cap *= self.growth
        self._next_err *= self.tightening

    def add(self, keys) -> None:
        keys = self._keys(keys)
        while keys.shape[0]:
            if not self.stages or self.counts[-1] >= self.caps[-1]:
                self._push_stage()
            room = self.caps[-1] - self.counts[-1]
            batch, keys = keys[:room], keys[room:]
            add = build(batch, torch.ones(batch.shape[0], dtype=torch.bool,
                                          device=self.device),
                        self.stages[-1].num_blocks, self.seed)
            self.stages[-1] = union(self.stages[-1], add)
            self.counts[-1] += int(batch.shape[0])

    def contains(self, keys) -> torch.Tensor:
        keys = self._keys(keys)
        out = torch.zeros(keys.shape, dtype=torch.bool, device=self.device)
        for st in self.stages:
            out = out | contains(st, keys)
        return out

    def merge(self, other: "ScalableFilter") -> "ScalableFilter":
        """Union of two SBFs: pairwise-union stages of equal geometry,
        carry extra stages verbatim (the upstream-PR semantics)."""
        if self.seed != other.seed:
            raise ValueError(f"merge: seeds {self.seed} != {other.seed}")
        a, b = self, other
        out = ScalableFilter(seed=self.seed, device=self.device)
        n = max(len(a.stages), len(b.stages))
        for i in range(n):
            if i < len(a.stages) and i < len(b.stages):
                if a.stages[i].num_blocks != b.stages[i].num_blocks:
                    raise ValueError("stage geometry mismatch: merge requires "
                                     "the same schedule")
                out.stages.append(union(a.stages[i], b.stages[i]))
                out.caps.append(a.caps[i])
                out.errs.append(a.errs[i])
                out.counts.append(a.counts[i] + b.counts[i])
            else:
                src = a if i < len(a.stages) else b
                out.stages.append(src.stages[i])
                out.caps.append(src.caps[i])
                out.errs.append(src.errs[i])
                out.counts.append(src.counts[i])
        if out.caps:
            out._next_cap = out.caps[-1] * out.growth
            out._next_err = out.errs[-1] * out.tightening
        return out
