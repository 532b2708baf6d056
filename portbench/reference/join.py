"""Plain reference of a two-way ApproxJoin SUM query over generated inputs.

Written from the operator's definition, not from the program:

* keys are uint32 values carried in int64, ``0xFFFFFFFF`` reserved;
* each input gets a split-block Bloom filter (Parquet/Impala layout: one
  256-bit block a key, one bit in each of its eight 32-bit lanes) sized by
  the paper's Eq. 27 from the largest input's power-of-two capacity, rounded
  up to a power-of-two number of blocks; the join filter is their AND, and a
  row is live when its key passes the join filter;
* strata are the distinct live keys of the first input in ascending order,
  the first ``max_strata`` kept; each input's rows of a stratum are its live
  rows with that key, in their original order;
* the exact SUM(v1 + v2) is summed over the strata that every input holds,
  COUNT is the sum of the strata's populations and AVG their quotient;
* a sampled SUM draws ``n_i`` edges of a joinable stratum with replacement,
  draw ``t`` taking row ``counter_hash(seed, key, t, side) % count`` of each
  side's rows of the stratum, and estimates the total with the stratified
  expansion estimator and a t interval (the paper's Eq. 12-14); ``n_i`` is
  the pilot fraction of the stratum's population on a query's first
  execution and, on each later one, the paper's Eq. 9/10 on the sigmas its
  last execution measured (:func:`replay`), at most ``b_max`` either way.

Every float is computed in ``dtype``: float64 for the reference, a lower
precision for the control.  Nothing here imports the program.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import NamedTuple, Optional

import torch

MASK = 0xFFFFFFFF
SENTINEL = MASK
GOLDEN = 0x9E3779B1
MIX = 0x85EBCA6B
SALT = (0x47B6137B, 0x44974D91, 0x8824AD5B, 0xA2B7289D,
        0x705495C7, 0x2DF1424B, 0x9EFC4947, 0x5C6BFB31)
LANES = 8
BITS_PER_BLOCK = 32 * LANES
# draw-grid cells a pass of the sampler holds
_DRAW_CHUNK = 1 << 24


def fmix32(h):
    """Murmur3's 32-bit finalizer on uint32 values held in int64 (a Python
    int or a tensor)."""
    h = h & MASK
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK
    return h ^ (h >> 16)


def seeded_hash(keys: torch.Tensor, seed: int) -> torch.Tensor:
    """fmix32(key ^ fmix32(seed * GOLDEN))."""
    return fmix32(keys ^ fmix32((int(seed) * GOLDEN) & MASK))


def counter_hash(seed: int, key: torch.Tensor, counter: torch.Tensor,
                 lane: int) -> torch.Tensor:
    """The sampler's stateless draw for (key, counter, side) under seed."""
    h = fmix32(((counter * GOLDEN) & MASK) + lane)
    h = fmix32(h ^ ((key * MIX) & MASK))
    return fmix32(h ^ (int(seed) & MASK))


def pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def num_blocks_for(n_keys: int, fp_rate: float) -> int:
    """Eq. 27, |BF| = -N ln p / (ln 2)^2 bits, as a power-of-two number of
    256-bit blocks."""
    bits = -max(int(n_keys), 1) * math.log(max(min(fp_rate, 0.5), 1e-12)) \
        / math.log(2) ** 2
    return pow2_at_least(max(1, math.ceil(bits / BITS_PER_BLOCK)))


def _cells(keys: torch.Tensor, num_blocks: int, seed: int):
    """Each key's eight bit cells in a [num_blocks * 256] grid, one lane at a
    time."""
    h = seeded_hash(keys, seed)
    base = (h & (num_blocks - 1)) * BITS_PER_BLOCK
    m = fmix32(((h * MIX) & MASK) + 1)
    del h
    for lane, salt in enumerate(SALT):
        yield base + lane * 32 + (((m * salt) & MASK) >> 27)


def bloom_grid(keys: torch.Tensor, num_blocks: int, seed: int
               ) -> torch.Tensor:
    """The filter of ``keys`` as a flat bool grid of its bits."""
    grid = torch.zeros(num_blocks * BITS_PER_BLOCK, dtype=torch.bool,
                       device=keys.device)
    for cell in _cells(keys, num_blocks, seed):
        grid[cell] = True
    return grid


def bloom_contains(grid: torch.Tensor, keys: torch.Tensor, num_blocks: int,
                   seed: int) -> torch.Tensor:
    ok = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    for cell in _cells(keys, num_blocks, seed):
        ok &= grid[cell]
    return ok


class Prepared(NamedTuple):
    """What the reference derives once per dataset and filter seed."""

    live: list                # live rows of each input (ints)
    keys: torch.Tensor        # int64 [S], SENTINEL past the strata
    valid: torch.Tensor       # bool [S]
    starts: torch.Tensor      # int64 [n, S] first row of each side's segment
    counts: torch.Tensor      # int64 [n, S]
    overflow: int             # strata beyond max_strata
    num_strata: int           # joinable strata
    joinable: torch.Tensor    # bool [S]
    population: torch.Tensor  # dtype [S], the product of the counts
    values: list              # dtype [live rows] of each side, sorted by key
    truth: float              # exact SUM(v1 + ... + vn), computed in dtype
    count: float              # exact COUNT, computed in dtype
    dtype: torch.dtype


def prepare(rels, *, fp_rate: float, max_strata: int, filter_seed: int,
            dtype=torch.float64) -> Prepared:
    """``rels``: each input's (keys int64, values float32) rows, all valid."""
    cap = max(pow2_at_least(k.shape[0]) for k, _ in rels)
    nb = num_blocks_for(cap, fp_rate)
    grid = None
    for keys, _ in rels:
        g = bloom_grid(keys, nb, filter_seed)
        grid = g if grid is None else grid & g
        del g
    sides = []
    for keys, values in rels:
        ok = bloom_contains(grid, keys, nb, filter_seed)
        k, order = torch.sort(keys[ok], stable=True)
        sides.append((k, values[ok][order].to(dtype)))
    del grid
    uniq = torch.unique_consecutive(sides[0][0])
    S = max_strata
    kept = min(uniq.shape[0], S)
    dev = uniq.device
    skeys = torch.full((S,), SENTINEL, dtype=torch.int64, device=dev)
    skeys[:kept] = uniq[:kept]
    valid = torch.arange(S, device=dev) < kept
    starts, counts, sums = [], [], []
    for k, v in sides:
        lo = torch.searchsorted(k, skeys, right=False)
        hi = torch.searchsorted(k, skeys, right=True)
        starts.append(lo)
        counts.append(torch.where(valid, hi - lo, 0))
        slot = torch.clamp(torch.searchsorted(skeys, k), max=S - 1)
        hit = (skeys[slot] == k) & valid[slot]
        sums.append(torch.zeros(S, dtype=dtype, device=dev).index_add_(
            0, slot[hit], v[hit]))
    counts_t = torch.stack(counts)
    joinable = valid & (counts_t > 0).all(0)
    cf = counts_t.to(dtype)
    population = torch.where(joinable, cf.prod(0), 0).to(dtype)
    total = torch.zeros(S, dtype=dtype, device=dev)
    for s, sm in enumerate(sums):
        others = torch.where(joinable, population / torch.clamp(cf[s], min=1),
                             0).to(dtype)
        total = total + sm * others
    return Prepared([int(k.shape[0]) for k, _ in sides], skeys, valid,
                    torch.stack(starts), counts_t,
                    max(int(uniq.shape[0]) - S, 0), int(joinable.sum()),
                    joinable, population, [v for _, v in sides],
                    float(total.sum()), float(population.sum()), dtype)


def t_quantile(p: float, df: float) -> float:
    """Student-t quantile by the Cornish-Fisher expansion around the normal
    (df clamped to 1)."""
    df = max(df, 1.0)
    z = NormalDist().inv_cdf(p)
    g1 = (z ** 3 + z) / 4.0
    g2 = (5.0 * z ** 5 + 16.0 * z ** 3 + 3.0 * z) / 96.0
    g3 = (3.0 * z ** 7 + 19.0 * z ** 5 + 17.0 * z ** 3 - 15.0 * z) / 384.0
    return z + g1 / df + g2 / df ** 2 + g3 / df ** 3


class Sampled(NamedTuple):
    n: torch.Tensor           # int64 [S] draws of each stratum
    estimate: float
    bound: float
    sigma: torch.Tensor       # dtype [S] the draws' standard deviation


def pilot_draws(prep: Prepared, fraction: float, b_max: int) -> torch.Tensor:
    """A query's first execution: ``ceil(fraction * B_i)`` draws of each
    joinable stratum (at least one), at most ``b_max``."""
    pop = prep.population
    b = torch.where(pop > 0, torch.clamp(torch.ceil(fraction * pop), min=1),
                    0)
    return torch.clamp(b, max=b_max).to(torch.int64)


def error_draws(prep: Prepared, sigma: torch.Tensor, error: float,
                confidence: float, b_max: int) -> torch.Tensor:
    """The paper's Eq. 9/10 under an error budget: ``b_i = ceil((z sigma_i /
    error)^2)``, at most ``B_i`` and at least one, then at most ``b_max``;
    z is the normal quantile of the confidence."""
    pop = prep.population
    z = t_quantile(0.5 + confidence / 2.0, 1e6)
    b = torch.minimum(torch.ceil((z * sigma / max(error, 1e-12)) ** 2), pop)
    b = torch.where(pop > 0, torch.clamp(b, min=1), 0)
    return torch.clamp(b, max=b_max).to(torch.int64)


def sample(prep: Prepared, seed: int, n: torch.Tensor, *,
           confidence: float = 0.95) -> Sampled:
    """The sampled SUM of one request that draws ``n[i]`` edges of joinable
    stratum ``i``: the CLT estimate, its bound and each stratum's sigma."""
    dt = prep.dtype
    idx = torch.nonzero(prep.joinable).flatten()
    n_j = n[idx]
    keys = prep.keys[idx]
    sum_f = torch.zeros(idx.shape[0], dtype=dt, device=idx.device)
    sum_f2 = torch.zeros_like(sum_f)
    s_seed = ((int(seed) & MASK) + 1) & MASK
    width = max(int(n_j.max()) if idx.numel() else 1, 1)
    t = torch.arange(width, device=idx.device)[None, :]
    step = max(1, _DRAW_CHUNK // width)
    for lo in range(0, idx.shape[0], step):
        sl = slice(lo, lo + step)
        f = 0
        for side, vals in enumerate(prep.values):
            cnt = torch.clamp(prep.counts[side, idx[sl]], min=1)[:, None]
            h = counter_hash(s_seed, keys[sl, None], t, side)
            f = f + vals[prep.starts[side, idx[sl], None] + h % cnt]
        f = torch.where(t < n_j[sl, None], f, 0).to(dt)
        sum_f[sl] = f.sum(1)
        sum_f2[sl] = (f * f).sum(1)
    nf = torch.clamp(n_j, min=1).to(dt)
    popd = prep.population[idx]
    tau = (popd * sum_f / nf).sum()
    r2 = torch.clamp((sum_f2 - sum_f * sum_f / nf)
                     / torch.clamp(nf - 1, min=1), min=0)
    fpc = torch.clamp(popd - nf, min=0)
    var = torch.where(n_j > 1, popd * fpc * r2 / nf, 0).to(dt).sum()
    dof = max(float(n_j.sum()) - idx.shape[0], 1.0)
    tq = torch.tensor(t_quantile(0.5 + confidence / 2.0, dof), dtype=dt)
    bound = tq * torch.sqrt(var.cpu())
    sigma = torch.zeros(prep.keys.shape[0], dtype=dt, device=idx.device)
    sigma[idx] = torch.sqrt(r2)
    return Sampled(n, float(tau), float(bound), sigma)


def exact(prep: Prepared, agg: str) -> float:
    """The exact SUM, COUNT or AVG of ``v1 + ... + vn`` over the join."""
    if agg == "sum":
        return prep.truth
    if agg == "count":
        return prep.count
    if agg == "avg":
        return prep.truth / max(prep.count, 1.0)
    raise ValueError(f"the reference has no exact {agg!r}")


def replay(preps: list, queries: list, sent: list, *, b_max: int) -> list:
    """The reference's answer to every request of ``sent``, in the order
    they were sent: a float for an exact query, a :class:`Sampled` for one
    under an error budget.

    ``sent`` holds one dict a request (``query_id``, ``dataset``, the index
    of its ``query`` in ``queries``, ``seed``); a query is ``agg``, ``expr``
    and ``budget`` (``{}`` exact, else ``error``, ``confidence``,
    ``pilot_fraction``).  Sampled requests of one query id form a chain, as
    the paper's §3.2-II feedback makes them: the first draws the pilot
    fraction; each later one sizes its draws from the sigmas the last
    measured (1.0 where none was, a stratum's sigma measured only where it
    drew two or more)."""
    chains: dict = {}
    out = []
    for r in sent:
        prep, q = preps[r["dataset"]], queries[r["query"]]
        budget = q.get("budget") or {}
        if q.get("expr", "sum") != "sum":
            raise ValueError(f"the reference has no expr {q['expr']!r}")
        if not budget:
            out.append(exact(prep, q["agg"]))
            continue
        if set(budget) - {"error", "confidence", "pilot_fraction"} \
                or q["agg"] != "sum":
            raise ValueError(f"the reference has no sampled {q}")
        conf = budget.get("confidence", 0.95)
        key = r["query_id"]
        dataset, sigma = chains.get(key, (r["dataset"], None))
        if dataset != r["dataset"]:
            raise ValueError(f"query id {key!r} spans datasets")
        if sigma is None:
            n = pilot_draws(prep, budget.get("pilot_fraction", 0.1), b_max)
            sigma = torch.ones(prep.keys.shape[0], dtype=prep.dtype,
                               device=prep.keys.device)
        else:
            n = error_draws(prep, sigma, budget["error"], conf, b_max)
        s = sample(prep, r["seed"], n, confidence=conf)
        chains[key] = (dataset, torch.where(n > 1, s.sigma, sigma))
        out.append(s)
    return out
