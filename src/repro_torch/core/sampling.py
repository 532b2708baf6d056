"""Stratified sampling *during* the join (paper §3.3, Algorithm 2).

The join of n relations on key C_i is the complete n-partite graph over the
per-side tuple groups; sampling the join output = sampling edges from that
graph without materializing it.  Per stratum (join key) we draw ``b_i`` edges
by picking one endpoint per side with a counter-based stateless hash:

    idx_side = start_side + counter_hash(seed, key, draw, side) % count_side

The plain path here is vectorized over a [S, b_max] grid (S = strata
capacity, b_max = per-stratum draw capacity); the two-way CUDA sampler
(``kernels/edge_sample.py``) computes the same statistics without the grid.
Draws are keyed by the join key (not the stratum index), so the sample does
not depend on how tuples were partitioned.

``build_strata`` identifies strata from the sorted lead relation and locates
each stratum's segment in every side with ``searchsorted``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from repro_torch.core.estimators import StratumStats
from repro_torch.core.hashing import (GOLDEN, MASK, bounded, counter_hash,
                                      fmix32, hash2)
from repro_torch.core.relation import Relation

SENTINEL = 0xFFFFFFFF  # invalid-row key fill; real keys must be < 2^32 - 1


class Strata(NamedTuple):
    """Join strata: one row per distinct key of the (sorted) lead relation.

    ``starts``/``counts`` are [n_sides, S]: the segment of each stratum in
    each side's sorted key array.  ``joinable`` marks strata present
    (count > 0) on every side; only those produce join output.
    ``population`` is exact int64: a stratum can hold more edges than
    float32 counts exactly (2^24), so each float32 consumer casts it.
    The properties reduce over the side axis (-2) and the strata axis (-1),
    so they hold for slot-stacked strata (``[B, ...]`` leaves) too.
    """

    keys: torch.Tensor      # int64 [S], uint32 values
    valid: torch.Tensor     # bool  [S] stratum slot holds a real key
    starts: torch.Tensor    # int64 [n_sides, S]
    counts: torch.Tensor    # int64 [n_sides, S]
    overflow: torch.Tensor  # int64 [] strata beyond capacity S (diagnostic)

    @property
    def joinable(self) -> torch.Tensor:
        return self.valid & torch.all(self.counts > 0, dim=-2)

    @property
    def population(self) -> torch.Tensor:
        """B_i: join-output size per stratum, the exact int64 product of
        the side counts (0 where not joinable)."""
        return torch.where(self.joinable,
                           torch.prod(torch.clamp(self.counts, min=0), dim=-2),
                           0)

    @property
    def num_strata(self) -> torch.Tensor:
        """m: number of joinable strata."""
        return self.joinable.sum(-1)


def _segment(sorted_keys: torch.Tensor, stratum_keys: torch.Tensor):
    start = torch.searchsorted(sorted_keys, stratum_keys, side="left")
    end = torch.searchsorted(sorted_keys, stratum_keys, side="right")
    return start, end - start


def build_strata(sorted_rels: Sequence[Relation], max_strata: int) -> Strata:
    """Identify strata from sorted_rels[0]; locate segments in every side.

    All relations must already be sorted by ``masked_keys()`` (invalid rows
    filled with SENTINEL sort last).  Strata beyond ``max_strata`` are counted
    in ``overflow`` and dropped.
    """
    lead = sorted_rels[0]
    mk = lead.masked_keys(SENTINEL)
    change = torch.ones(min(mk.shape[0], 1), dtype=torch.bool, device=mk.device)
    is_start = lead.valid & torch.cat([change, mk[1:] != mk[:-1]])
    sid = torch.cumsum(is_start.to(torch.int64), 0) - 1  # stratum per row
    total = is_start.sum()
    S = max_strata
    # only the first row of each kept stratum writes (the reference routes
    # every other row to an overflow slot, one address for all of them)
    first = is_start & (sid < S)
    keys = torch.full((S,), SENTINEL, dtype=torch.int64, device=mk.device)
    keys[sid[first]] = mk[first]
    valid = torch.arange(S, device=mk.device) < torch.clamp(total, max=S)
    starts, counts = [], []
    for r in sorted_rels:
        s, c = _segment(r.masked_keys(SENTINEL), keys)
        starts.append(s)
        counts.append(torch.where(valid, c, 0))
    return Strata(keys, valid, torch.stack(starts), torch.stack(counts),
                  torch.clamp(total - S, min=0))


def edge_indices(strata: Strata, b_max: int, seed) -> torch.Tensor:
    """Draw endpoint indices for every (stratum, draw, side).

    Returns int64 [n_sides, S, b_max]: absolute row indices into each side's
    sorted arrays.  Pure function of (seed, join key, draw counter, side).
    """
    n_sides = strata.starts.shape[0]
    t = torch.arange(b_max, device=strata.keys.device)[None, :]
    keys = strata.keys[:, None]
    idx = []
    for side in range(n_sides):
        h = counter_hash(seed, keys, t, side)                 # [S, b_max]
        cnt = torch.clamp(strata.counts[side], min=1)[:, None]
        idx.append(strata.starts[side][:, None] + bounded(h, cnt))
    return torch.stack(idx)


def edge_id(idx_in_stratum: torch.Tensor) -> torch.Tensor:
    """Collision-resistant id of an edge from per-side in-stratum offsets.

    [n_sides, S, b_max] -> uint32 values [S, b_max] (int64).  Collision
    probability within a stratum is ~b_max^2 / 2^33; only the dedup path
    uses it.
    """
    h = 0
    for side in range(idx_in_stratum.shape[0]):
        h = fmix32(((h * GOLDEN) & MASK) ^ (idx_in_stratum[side] & MASK))
    return h


class SampleResult(NamedTuple):
    stats: StratumStats           # with-replacement sufficient statistics
    unique_f: torch.Tensor        # [S] sum of f over *distinct* edges (HT)
    unique_count: torch.Tensor    # [S] number of distinct edges
    f_values: torch.Tensor        # [S, b_max] sampled f(edge) (0 if masked)
    mask: torch.Tensor            # bool [S, b_max] draw validity


def default_f(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """The paper's running aggregate: SUM(R1.V + R2.V + ... + Rn.V)."""
    out = values[0]
    for v in values[1:]:
        out = out + v
    return out


def sample_edges(sorted_rels: Sequence[Relation], strata: Strata,
                 b_i: torch.Tensor, b_max: int, seed,
                 f: Callable[[Sequence[torch.Tensor]], torch.Tensor]
                 = default_f) -> SampleResult:
    """Algorithm 2, vectorized: draw, gather, aggregate per stratum.

    ``b_i`` is float [S], the per-stratum budget from the cost function
    (§3.2); actual draws are ``min(b_i, b_max)`` over joinable strata.
    """
    S = strata.keys.shape[0]
    idx = edge_indices(strata, b_max, seed)                   # [n, S, b_max]
    # a stratum absent from a side has start == capacity there; its draws
    # are masked, and the clamp only keeps their gather in bounds
    vals = [r.values[torch.clamp(idx[side], max=r.capacity - 1)]
            for side, r in enumerate(sorted_rels)]
    fv = f(vals)                                              # [S, b_max]
    t = torch.arange(b_max, dtype=torch.float32, device=fv.device)[None, :]
    mask = (t < b_i.to(torch.float32)[:, None]) & strata.joinable[:, None]
    fm = torch.where(mask, fv, 0.0)
    stats = StratumStats(
        valid=strata.joinable,
        population=strata.population,
        n_sampled=mask.sum(1, dtype=torch.float32),
        sum_f=fm.sum(1),
        sum_f2=(fm * fm).sum(1),
    )
    # --- dedup path (Horvitz-Thompson, §3.4-II) ---
    eid = edge_id(idx - strata.starts[:, :, None])            # [S, b_max]
    eid = torch.where(mask, eid, SENTINEL)
    order = torch.argsort(eid, dim=1, stable=True)
    eid_s = torch.gather(eid, 1, order)
    fv_s = torch.gather(fm, 1, order)
    first = torch.cat([torch.ones((S, 1), dtype=torch.bool, device=fv.device),
                       eid_s[:, 1:] != eid_s[:, :-1]], dim=1)
    keep = first & (eid_s != SENTINEL)
    unique_f = torch.where(keep, fv_s, 0.0).sum(1)
    unique_count = keep.sum(1, dtype=torch.float32)
    return SampleResult(stats, unique_f, unique_count, fm, mask)


# ---------------------------------------------------------------------------
# Exact aggregates from sufficient statistics.  The cartesian structure of
# the join makes SUM-type aggregates separable:
#   sum over edges of  sum_k v_k  =  sum_k ( S_k * prod_{j != k} B_j )
#   sum over edges of prod_k v_k  =  prod_k S_k
# computed per stratum in one segment-sum pass: O(N), no cross product.
# ---------------------------------------------------------------------------

def per_stratum_value_sums(sorted_rels, strata) -> torch.Tensor:
    """[n_sides, S] sum of values per stratum per side.

    A segment sum over the sorted rows, where a stratum's rows lie together:
    each stratum's sum depends only on its own rows, added in the same
    order on every call.  (A float scatter-add on the card adds in the order
    its atomics land, so two calls on the same rows could differ in their
    last bits.)  Only the rows that belong to a stratum are added: the
    reference sends the others to an overflow row.
    """
    S = strata.keys.shape[0]
    bounds = torch.arange(S + 1, device=strata.keys.device)
    sums = []
    for r in sorted_rels:
        mk = r.masked_keys(SENTINEL)
        slot = torch.clamp(torch.searchsorted(strata.keys, mk), 0, S - 1)
        ok = r.valid & (strata.keys[slot] == mk) & strata.valid[slot]
        # the rows are sorted by key, so slot[ok] ascends
        offsets = torch.searchsorted(slot[ok], bounds)
        sums.append(torch.segment_reduce(r.values[ok], "sum", offsets=offsets,
                                         unsafe=True))
    return torch.stack(sums)


def exact_sum_of_sums_from(S_k: torch.Tensor, strata: Strata) -> torch.Tensor:
    """Finish SUM(v_1 + ... + v_n) from per-stratum value sums [n, S]."""
    B_k = torch.clamp(strata.counts, min=0).to(torch.float32)   # [n, S]
    total_B = strata.population.to(torch.float32)               # [S]
    per_stratum = torch.zeros_like(total_B)
    for k in range(S_k.shape[0]):
        term = torch.where(B_k[k] > 0,
                           S_k[k] * (total_B / torch.clamp(B_k[k], min=1.0)),
                           0.0)
        per_stratum = per_stratum + term
    return torch.where(strata.joinable, per_stratum, 0.0).sum()


def exact_sum_of_products_from(S_k: torch.Tensor,
                               strata: Strata) -> torch.Tensor:
    """Finish SUM(v_1 * ... * v_n) from per-stratum value sums [n, S]."""
    per_stratum = torch.prod(S_k, dim=0)
    return torch.where(strata.joinable, per_stratum, 0.0).sum()


def exact_sum_of_sums(sorted_rels, strata) -> torch.Tensor:
    """Exact SUM(v_1 + ... + v_n) over the join output."""
    return exact_sum_of_sums_from(per_stratum_value_sums(sorted_rels, strata),
                                  strata)


def exact_sum_of_products(sorted_rels, strata) -> torch.Tensor:
    """Exact SUM(v_1 * ... * v_n) over the join output."""
    return exact_sum_of_products_from(
        per_stratum_value_sums(sorted_rels, strata), strata)


def exact_count(strata: Strata) -> torch.Tensor:
    """COUNT of the join output, float32 like every other aggregate."""
    return strata.population.to(torch.float32).sum()


# ---------------------------------------------------------------------------
# Merge-able per-stratum reservoirs (streaming, StreamApprox-style).
#
# A bounded uniform sample per stratum over an unbounded stream of values:
# every item gets a priority from the stateless counter hash keyed on its
# arrival identity (tick, row), never on which reservoir folded it, and a
# stratum from its key hash; the reservoir is the bottom-``cap`` priorities
# per stratum.  Bottom-k by a uniform priority is a uniform sample without
# replacement, and it makes the sketch exactly mergeable: bottom-k of a
# union needs only the bottom-k of each part, so ``extend(extend(E, A), B)``
# equals ``merge(extend(E, A), extend(E, B))`` bit for bit (up to u32
# priority ties, ~n^2/2^33).  Every sort is stable, so ties keep the same
# values the JAX implementation keeps, and a fold on the card equals the
# same fold on the CPU.
# ---------------------------------------------------------------------------

class Reservoir(NamedTuple):
    """Per-stratum bottom-k value reservoir (priority SENTINEL = empty slot).

    ``n_seen`` counts every valid item ever offered per stratum: the
    denominator that turns the reservoir into rate/moment estimates.
    """

    priority: torch.Tensor  # int64 [S, cap], uint32 values, ascending per row
    values: torch.Tensor    # float32 [S, cap]
    n_seen: torch.Tensor    # float32 [S]


def reservoir_empty(num_strata: int, cap: int, device="cuda") -> Reservoir:
    return Reservoir(
        torch.full((num_strata, cap), SENTINEL, dtype=torch.int64,
                   device=device),
        torch.zeros((num_strata, cap), dtype=torch.float32, device=device),
        torch.zeros((num_strata,), dtype=torch.float32, device=device))


def _keep_bottom(priority: torch.Tensor, values: torch.Tensor, cap: int):
    order = torch.argsort(priority, dim=1, stable=True)
    return (torch.gather(priority, 1, order)[:, :cap],
            torch.gather(values, 1, order)[:, :cap])


def reservoir_extend(res: Reservoir, keys: torch.Tensor, values: torch.Tensor,
                     valid: torch.Tensor, seed, tick) -> Reservoir:
    """Fold one micro-batch into the reservoir.

    ``tick`` is the arrival index of the batch (unique per fold of the same
    stream: priorities are ``counter_hash(seed, tick, row, 3)``, so reusing
    a tick would replay the same priorities).  Stratum assignment is
    ``hash2(key, seed) % S``.  Invalid rows are ignored everywhere.
    """
    S, cap = res.priority.shape
    n = keys.shape[0]
    dev = keys.device
    # nothing here waits for the card (a fold runs on every push): the
    # modulus is a Python int, where ``bounded`` would upload a tensor, and
    # the counts an index_add_, where a bincount would read its maximum
    sid = hash2(keys, seed) % max(S, 1)                          # [n]
    rows = torch.arange(n, device=dev)
    pri = counter_hash(seed, tick, rows, 3)
    pri = torch.where(pri == SENTINEL, SENTINEL - 1, pri)
    # stage only the batch's bottom-cap per stratum (bottom-k of a union
    # needs only the bottom-k of each part): order by (stratum, priority,
    # row) — one stable sort of stratum * 2^32 + priority, the order of the
    # JAX implementation's lexsort — rank within the stratum's run, keep
    # ranks < cap; the final per-row sort runs over [S, 2 * cap]
    d = torch.where(valid, sid, S)
    order = torch.argsort((d << 32) | pri, stable=True)
    ds = d[order]
    pos = torch.arange(n, device=dev)
    is_start = torch.cat([torch.ones(min(n, 1), dtype=torch.bool, device=dev),
                          ds[1:] != ds[:-1]])
    slot = pos - torch.cummax(torch.where(is_start, pos, 0), 0).values
    ok = (ds < S) & (slot < cap)
    # rows that stay out land in the extra last cell, which is cut off
    flat = torch.where(ok, ds * cap + slot, S * cap)
    grid_p = torch.full((S * cap + 1,), SENTINEL, dtype=torch.int64,
                        device=dev)
    grid_p[flat] = pri[order]
    grid_v = torch.zeros((S * cap + 1,), dtype=torch.float32, device=dev)
    grid_v[flat] = values[order]
    p, v = _keep_bottom(
        torch.cat([res.priority, grid_p[:-1].view(S, cap)], dim=1),
        torch.cat([res.values, grid_v[:-1].view(S, cap)], dim=1), cap)
    seen = torch.zeros(S + 1, dtype=torch.int64, device=dev).index_add_(
        0, d, torch.ones_like(d))[:S]
    return Reservoir(p, v, res.n_seen + seen.to(torch.float32))


def reservoir_merge(a: Reservoir, b: Reservoir) -> Reservoir:
    """Union of two reservoirs over disjoint (tick-distinct) sub-streams."""
    assert a.priority.shape == b.priority.shape, (a.priority.shape,
                                                 b.priority.shape)
    cap = a.priority.shape[1]
    p, v = _keep_bottom(torch.cat([a.priority, b.priority], dim=1),
                        torch.cat([a.values, b.values], dim=1), cap)
    return Reservoir(p, v, a.n_seen + b.n_seen)


def reservoir_fill(res: Reservoir) -> torch.Tensor:
    """Occupied slots per stratum ([S] float32): min(n_seen, cap)."""
    return (res.priority != SENTINEL).sum(1, dtype=torch.float32)


def reservoir_moments(res: Reservoir):
    """(n [S], mean [S], var [S]) of the reservoir sample per stratum.

    Unbiased sample mean/variance of the stream per stratum (the reservoir
    is a uniform sample); feeds streaming sigma diagnostics.
    """
    m = res.priority != SENTINEL
    n = m.sum(1, dtype=torch.float32)
    nz = torch.clamp(n, min=1.0)
    mean = torch.where(m, res.values, 0.0).sum(1) / nz
    var = torch.where(m, (res.values - mean[:, None]) ** 2, 0.0).sum(1) \
        / torch.clamp(n - 1.0, min=1.0)
    return n, mean, var
