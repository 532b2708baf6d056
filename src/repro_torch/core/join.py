"""ApproxJoin: the paper's operator, end to end (single device).

Pipeline (paper Fig. 2/7):

  1. build a Bloom filter per input                         (§3.1, Alg. 1)
  2. AND them into the join filter, probe, drop dead tuples (§3.1)
  3. group surviving tuples into strata (sort + segments)   (§3.3)
  4. decide: exact join affordable? else pick b_i            (§3.1.1, §3.2)
  5. stratified edge-sampling during the join               (§3.3, Alg. 2)
  6. estimate + error bound (CLT or Horvitz-Thompson)       (§3.4)

The orchestration is Python (Spark's coordinating role); every stage is a
function of tensors.  ``use_kernels=True`` routes the filter build, the probe
and the two-way sampler through the CUDA kernels (``kernels/ops.py``).
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import bloom
from repro_torch.core.budget import QueryBudget
from repro_torch.core.cost import (CostModel, SigmaRegistry, sizes_for_error,
                                   sizes_for_latency, sync)
from repro_torch.core.estimators import (StratumStats, clt_avg, clt_count,
                                         clt_stdev, clt_sum,
                                         horvitz_thompson_sum)
from repro_torch.core.relation import Relation, sort_by_key
from repro_torch.core.sampling import (SampleResult, Strata, build_strata,
                                       default_f, exact_count,
                                       exact_sum_of_products,
                                       exact_sum_of_products_from,
                                       exact_sum_of_sums,
                                       exact_sum_of_sums_from, sample_edges)

TUPLE_BYTES = 8  # uint32 key + float32 value


def filter_exchange_bytes(n: int, fbytes):
    """§3.1 filter-exchange transfer model: bytes moved to build + ship the
    join filter for an n-way join: the n per-dataset filters travel to the
    merge site and the AND-merged join filter is broadcast back once, hence
    (n + 1) filter-sized transfers."""
    return fbytes * (n + 1)


class JoinDiagnostics(NamedTuple):
    total_counts: torch.Tensor       # [n] tuples per input
    live_counts: torch.Tensor        # [n] tuples surviving the join filter
    overlap_fraction: torch.Tensor   # paper §3.1.1 definition
    filter_bytes: int                # |BF| bytes (per filter)
    shuffled_bytes_filtered: torch.Tensor    # live tuples + filters
    shuffled_bytes_repartition: torch.Tensor  # all tuples (baseline model)
    num_strata: torch.Tensor
    strata_overflow: torch.Tensor
    total_population: torch.Tensor   # sum_i B_i (join output size)
    sample_draws: torch.Tensor       # sum_i b_i actually drawn
    d_filter_s: float                # measured wall time of stages 1-3
    sampled: bool                    # False -> exact path was taken
    dist_dropped_tuples: float = 0.0  # mesh shuffle rows beyond bucket_cap
    d_sample_s: float = 0.0          # wall time of the exact aggregate or
    #                                  of drawing the sample (stages 4-5)
    d_estimate_s: float = 0.0        # wall time of the estimator (stage 6)


class JoinResult(NamedTuple):
    estimate: torch.Tensor
    error_bound: torch.Tensor
    count: torch.Tensor              # exact join-output cardinality
    dof: torch.Tensor
    diagnostics: JoinDiagnostics
    stats: Optional[StratumStats] = None
    strata: Optional[Strata] = None


EXPRS: dict = {
    "sum": (default_f, exact_sum_of_sums),
    "product": (lambda vs: torch.prod(torch.stack(vs), dim=0),
                exact_sum_of_products),
}


def build_join_filter(rels: Sequence[Relation], num_blocks: int,
                      seed: int) -> bloom.BloomFilter:
    """Alg. 1: per-input filters, AND-merged into the join filter."""
    filters = [bloom.build(r.keys, r.valid, num_blocks, seed) for r in rels]
    return bloom.intersect_all(filters)


def filter_relations(rels: Sequence[Relation],
                     join_filter: bloom.BloomFilter) -> list[Relation]:
    """Probe + discard (the shuffle-avoidance step)."""
    return [Relation(r.keys, r.values,
                     r.valid & bloom.contains(join_filter, r.keys))
            for r in rels]


# ---------------------------------------------------------------------------
# Stage functions.  approx_join composes them; a serving engine batches them.
# ---------------------------------------------------------------------------

class PrepareOut(NamedTuple):
    """Stages 1-3 output: live sorted relations + strata + row counts.

    ``population`` is ``strata.population`` in float32, as the host's
    decisions read it (a plain tensor, so it can be read off a slot-stacked
    batch too); the strata keep the exact int64 counts of edges.
    ``sorted_rows`` is ``live_counts`` as the host read it: the rows each
    side's sort took.
    """

    sorted_rels: list[Relation]
    strata: Strata
    live_counts: torch.Tensor   # int64 [n]
    total_counts: torch.Tensor  # int64 [n]
    population: torch.Tensor    # f32   [S]
    sorted_rows: torch.Tensor   # int64 [n], on the CPU


def _prepare_tail(live: Sequence[Relation], rels: Sequence[Relation],
                  max_strata: int,
                  counts: Optional[torch.Tensor] = None) -> PrepareOut:
    """Shared sort/group-by tail of every prepare variant.

    ``counts`` holds each side's live rows on the CPU; without it the tail
    reads them from the device, once for all sides.
    """
    live_counts = torch.stack([r.count() for r in live])
    if counts is None:
        counts = live_counts.cpu()
    sorted_rels = [sort_by_key(r, c) for r, c in zip(live, counts.tolist())]
    strata = build_strata(sorted_rels, max_strata)
    return PrepareOut(sorted_rels, strata, live_counts,
                      torch.stack([r.count() for r in rels]),
                      strata.population.to(torch.float32), counts)


def prepare_stage(rels: Sequence[Relation], num_blocks: int, max_strata: int,
                  seed) -> PrepareOut:
    """Filter build/AND/probe, sort, group-by (plain PyTorch)."""
    filters = [bloom.build(r.keys, r.valid, num_blocks, seed) for r in rels]
    join_filter = bloom.intersect_all(filters)
    return _prepare_tail(filter_relations(rels, join_filter), rels,
                         max_strata)


def prepare_stage_pre(rels: Sequence[Relation], filter_words: torch.Tensor,
                      max_strata: int, seed) -> PrepareOut:
    """:func:`prepare_stage` with PREBUILT per-input filter words
    ``[n_inputs, num_blocks, 8]`` (e.g. a per-dataset cache)."""
    if filter_words.shape[0] != len(rels):
        raise ValueError(
            f"prepare_stage_pre: {filter_words.shape[0]} prebuilt filters "
            f"for {len(rels)} inputs")
    join_filter = bloom.intersect_all(
        [bloom.BloomFilter(filter_words[i], seed)
         for i in range(filter_words.shape[0])])
    return _prepare_tail(filter_relations(rels, join_filter), rels,
                         max_strata)


def prepare_stage_kernels(rels: Sequence[Relation], num_blocks: int,
                          max_strata: int, seed, *,
                          filter_words: Optional[torch.Tensor] = None
                          ) -> PrepareOut:
    """Kernel-backed :func:`prepare_stage` / :func:`prepare_stage_pre`.

    Per-input filters come from the build kernel (or arrive PREBUILT as
    ``filter_words`` ``[n_inputs, num_blocks, 8]``), the AND-merge happens on
    the packed words, and the probe runs through the probe kernel.  Results
    equal the plain stages bit for bit.
    """
    from repro_torch.kernels import ops as kops
    if filter_words is None:
        words = bloom.intersect_all(
            [kops.build_filter(r.keys, r.valid, num_blocks, seed)
             for r in rels]).words
    else:
        if filter_words.shape[0] != len(rels):
            raise ValueError(
                f"prepare_stage_kernels: {filter_words.shape[0]} prebuilt "
                f"filters for {len(rels)} inputs")
        words = bloom.intersect_all(
            [bloom.BloomFilter(filter_words[i], seed)
             for i in range(filter_words.shape[0])]).words
    live = [Relation(r.keys, r.values,
                     r.valid & kops.probe_filter(words, r.keys, seed))
            for r in rels]
    return _prepare_tail(live, rels, max_strata)


def _stack(items):
    """Stack a list of per-slot NamedTuples (or tensors / lists) leafwise."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, list):
        return [_stack([it[i] for it in items]) for i in range(len(first))]
    return type(first)(*(_stack([it[i] for it in items])
                         for i in range(len(first))))


def _slot(tree, b: int):
    """Slot ``b`` of a slot-stacked NamedTuple / list of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree[b]
    if isinstance(tree, list):
        return [_slot(x, b) for x in tree]
    return type(tree)(*(_slot(x, b) for x in tree))


def pad_stack(outs: list, B: int):
    """Stack ``len(outs) <= B`` per-slot outputs leafwise, the last one
    repeated over the remaining slots."""
    return _stack(outs + outs[-1:] * (B - len(outs)))


def prepare_stage_kernels_batched(rels: Sequence[Relation],
                                  filter_words: torch.Tensor,
                                  max_strata: int, seeds,
                                  n_real: Optional[int] = None) -> PrepareOut:
    """Slot-batched kernel prepare: the serving engine's counterpart.

    ``rels`` carry slot-stacked ``[B, N]`` tensors, ``filter_words`` is
    ``[B, n_inputs, num_blocks, 8]`` (per-slot prebuilt words), ``seeds`` is
    ``[B]``.  The AND-merge and the probe run over the whole batch (the probe
    kernel owns the slot dimension); the sort/group-by tail runs per slot
    and is stacked, so every slot equals :func:`prepare_stage_kernels`.

    ``n_real`` says that the slots from ``n_real`` on repeat slot
    ``n_real - 1``'s inputs (an engine's pad slots): the tail then runs for
    the first ``n_real`` slots only, and the last one's outputs fill the
    rest, which is what running it for them would give.  The sorts take
    their live rows from one host read of the real slots' counts.
    """
    from repro_torch.kernels import ops as kops
    if filter_words.shape[1] != len(rels):
        raise ValueError(
            f"prepare_stage_kernels_batched: {filter_words.shape[1]} "
            f"prebuilt filters for {len(rels)} inputs")
    jwords = bloom.intersect_all(
        [bloom.BloomFilter(filter_words[:, i], seeds)
         for i in range(filter_words.shape[1])]).words
    live = [Relation(r.keys, r.values,
                     r.valid & kops.probe_filter_batched(jwords, r.keys, seeds))
            for r in rels]
    B = filter_words.shape[0]
    n = B if n_real is None else n_real
    counts = torch.stack([r.valid[:n].sum(-1) for r in live], -1).cpu()
    return pad_stack([_prepare_tail(_slot(live, b), _slot(list(rels), b),
                                    max_strata, counts[b])
                      for b in range(n)], B)


def _finish(est, cnt, agg: str):
    if agg == "count":
        return cnt, cnt
    if agg == "avg":
        return est / torch.clamp(cnt, min=1.0), cnt
    return est, cnt


def exact_stage(sorted_rels: Sequence[Relation], strata: Strata, *,
                agg: str, expr: str) -> tuple[torch.Tensor, torch.Tensor]:
    """§3.1.1 exact fast path: (estimate, count) from sufficient statistics."""
    return _finish(EXPRS[expr][1](sorted_rels, strata), exact_count(strata),
                   agg)


def exact_stage_from_sums(S_k: torch.Tensor, strata: Strata, *,
                          agg: str, expr: str
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`exact_stage` from per-stratum value sums ``[n, S]``."""
    finish = {"sum": exact_sum_of_sums_from,
              "product": exact_sum_of_products_from}[expr]
    return _finish(finish(S_k, strata), exact_count(strata), agg)


def estimate_stage(sample: SampleResult, *, agg: str, dedup: bool,
                   confidence: float):
    """§3.4: sufficient statistics -> (value, error bound, count, dof)."""
    if dedup:
        est = horvitz_thompson_sum(sample.stats, sample.unique_f,
                                   sample.unique_count, confidence)
    elif agg == "avg":
        est = clt_avg(sample.stats, confidence)
    elif agg == "stdev":
        est = clt_stdev(sample.stats, confidence)
    else:
        est = clt_sum(sample.stats, confidence)
    cnt = clt_count(sample.stats)
    value = cnt if agg == "count" else est.estimate
    err = torch.zeros_like(est.error_bound) if agg == "count" \
        else est.error_bound
    return value, err, cnt, est.dof


def sample_stage(sorted_rels: Sequence[Relation], strata: Strata,
                 b_i: torch.Tensor, b_max: int, seed, *,
                 agg: str = "sum", dedup: bool = False,
                 confidence: float = 0.95,
                 f_fn: Callable = None):
    """Stages 4-6 (sampled path): draw + aggregate + error bound."""
    sample = sample_edges(sorted_rels, strata, b_i, b_max, seed,
                          default_f if f_fn is None else f_fn)
    value, err, cnt, dof = estimate_stage(sample, agg=agg, dedup=dedup,
                                          confidence=confidence)
    return value, err, cnt, dof, sample.stats


def _kernel_sample_result(stats: StratumStats) -> SampleResult:
    """Wrap kernel StratumStats as a SampleResult (non-dedup: the HT/dedup
    fields are unused by :func:`estimate_stage`, stubbed to zeros)."""
    zeros = torch.zeros_like(stats.sum_f)
    return SampleResult(stats, zeros, zeros,
                        zeros.new_zeros((1, 1)),
                        torch.zeros((1, 1), dtype=torch.bool,
                                    device=zeros.device))


def sample_stage_kernels(sorted_rels: Sequence[Relation], strata: Strata,
                         b_i: torch.Tensor, b_max: int, seed, *,
                         agg: str = "sum", confidence: float = 0.95,
                         expr: str = "sum"):
    """Kernel-backed :func:`sample_stage` (two-way, non-dedup): the fused
    draw->gather->f->reduce sampler + the shared estimate stage."""
    from repro_torch.kernels import ops as kops
    stats = kops.sample_stats(sorted_rels, strata, b_i, b_max, seed, expr)
    value, err, cnt, dof = estimate_stage(
        _kernel_sample_result(stats), agg=agg, dedup=False,
        confidence=confidence)
    return value, err, cnt, dof, stats


def sample_stage_kernels_batched(sorted_rels: Sequence[Relation],
                                 strata: Strata, b_i: torch.Tensor,
                                 b_max: int, seeds, *,
                                 agg: str = "sum", confidence: float = 0.95,
                                 expr: str = "sum"):
    """Slot-batched kernel sample stage (engine counterpart).

    Inputs are slot-stacked (``[B, ...]`` leaves, as emitted by the batched
    prepare); the sampler kernel runs over the whole batch and the estimator
    finish runs per slot.
    """
    from repro_torch.kernels import ops as kops
    stats = kops.sample_stats_batched(
        sorted_rels[0].values, sorted_rels[1].values,
        strata.keys, strata.starts, strata.counts, strata.joinable,
        strata.population, b_i, seeds, b_max, expr)
    outs = [estimate_stage(_kernel_sample_result(_slot(stats, b)), agg=agg,
                           dedup=False, confidence=confidence)
            for b in range(b_i.shape[0])]
    value, err, cnt, dof = (torch.stack(x) for x in zip(*outs))
    return value, err, cnt, dof, stats


def _pilot_sizes(population, fraction: float) -> torch.Tensor:
    b = torch.ceil(fraction * population.to(torch.float32))
    return torch.where(population > 0, torch.clamp(b, min=1.0), 0.0)


def decide_sample_sizes(budget: QueryBudget, strata: Strata,
                        cost_model: Optional[CostModel], d_dt: float,
                        sigma: Optional[np.ndarray],
                        confidence: float) -> torch.Tensor:
    """§3.2: budget -> per-stratum b_i.  Latency and error combine by min."""
    population = strata.population
    b = None
    if budget.error is not None:
        if sigma is not None:
            b = sizes_for_error(budget.error, sigma, population, confidence)
        else:  # first execution: pilot run at a fixed fraction (§3.2-II)
            b = _pilot_sizes(population, budget.pilot_fraction)
    if budget.latency_s is not None:
        if cost_model is None:
            raise ValueError("a latency budget needs a CostModel")
        bl = sizes_for_latency(cost_model, budget.latency_s, d_dt, population)
        b = bl if b is None else torch.minimum(b, bl)
    if b is None:
        raise ValueError("decide_sample_sizes: the budget sets no bound")
    return b


def measured_sigma(stats: StratumStats) -> torch.Tensor:
    """Per-stratum sigma estimate fed back into the SigmaRegistry."""
    b = torch.clamp(stats.n_sampled, min=1.0)
    r2 = (stats.sum_f2 - stats.sum_f**2 / b) / torch.clamp(b - 1.0, min=1.0)
    return torch.sqrt(torch.clamp(r2, min=0.0))


def approx_join(rels: Sequence[Relation],
                budget: QueryBudget = QueryBudget(),
                *,
                agg: str = "sum",
                expr: str = "sum",
                f: Optional[Callable] = None,
                seed: int = 0,
                fp_rate: float = 0.01,
                max_strata: Optional[int] = None,
                b_max: Optional[int] = 2048,
                cost_model: Optional[CostModel] = None,
                sigma_registry: Optional[SigmaRegistry] = None,
                query_id: str = "q0",
                dedup: bool = False,
                use_kernels: bool = False) -> JoinResult:
    """The paper's approxjoin() (§4): join + aggregate within a budget.

    ``expr`` selects f over joined values ('sum' -> v1+...+vn); ``agg`` is the
    outer aggregate ('sum' | 'count' | 'avg' | 'stdev').  ``dedup=True``
    removes duplicate edges and switches to the Horvitz-Thompson estimator.
    ``use_kernels=True`` routes filter build/probe and the (two-way,
    non-dedup) sampler through the CUDA kernels (kernels/ops.py), or their
    plain versions for relations on the CPU; results are the same.
    """
    f_fn, exact_fn = EXPRS[expr] if f is None else (f, None)
    n = len(rels)
    max_n = max(r.capacity for r in rels)
    # size the strata grid from the LARGEST input, so a later, bigger
    # relation cannot overflow it in exact mode
    S = max_strata or max_n

    # --- stage 1: filtering (timed: feeds d_dt in the latency cost fn) ---
    t0 = time.perf_counter()
    num_blocks = bloom.num_blocks_for(max_n, fp_rate)
    if use_kernels:
        prep = prepare_stage_kernels(rels, num_blocks, S, seed)
    else:
        prep = prepare_stage(rels, num_blocks, S, seed)
    sorted_rels, strata = prep.sorted_rels, prep.strata
    live_counts, total_counts = prep.live_counts, prep.total_counts
    sync(strata.counts.device)
    d_filter = time.perf_counter() - t0

    population = strata.population
    total_pop = population.sum()
    overlap = live_counts.sum() / torch.clamp(total_counts.sum(), min=1)
    fbytes = num_blocks * bloom.WORDS_PER_BLOCK * 4
    diag = dict(
        total_counts=total_counts, live_counts=live_counts,
        overlap_fraction=overlap, filter_bytes=fbytes,
        shuffled_bytes_filtered=live_counts.sum() * TUPLE_BYTES
        + filter_exchange_bytes(n, fbytes),
        shuffled_bytes_repartition=total_counts.sum() * TUPLE_BYTES,
        num_strata=strata.num_strata, strata_overflow=strata.overflow,
        total_population=total_pop, d_filter_s=d_filter,
    )

    # --- stage 2: exact fast path (§3.1.1 "is filtering sufficient?") ---
    exact_affordable = budget.is_exact or (
        budget.latency_s is not None and cost_model is not None
        and exact_fn is not None
        and float(cost_model.beta_compute) * float(total_pop)
        + cost_model.epsilon + d_filter <= budget.latency_s
        and budget.error is None)
    zero = torch.zeros((), device=total_pop.device)
    if exact_affordable:
        if exact_fn is None:
            raise ValueError("the exact path needs a separable expr")
        t1 = time.perf_counter()
        est, cnt = exact_stage(sorted_rels, strata, agg=agg, expr=expr)
        sync(est.device)
        return JoinResult(est, zero, cnt, zero,
                          JoinDiagnostics(sample_draws=zero, sampled=False,
                                          d_sample_s=time.perf_counter() - t1,
                                          **diag),
                          strata=strata)

    # --- stage 3: budget -> b_i (§3.2) ---
    sigma = None
    if (budget.error is not None and sigma_registry is not None
            and sigma_registry.has(query_id)):
        sigma = sigma_registry.lookup(query_id, strata.keys.cpu().numpy())
    b_i = decide_sample_sizes(budget, strata, cost_model, d_filter, sigma,
                              budget.confidence)
    if b_max is None:
        # adaptive grid: size the [S, b_max] draw grid from the budget
        # (pow2-bucketed), so latency follows b_i
        peak = int(b_i.max().item())
        b_max = max(64, 1 << (min(peak, 8192) - 1).bit_length())

    # --- stage 4+5: sample during join (§3.3) ---
    t1 = time.perf_counter()
    if use_kernels and not dedup and n == 2 and f is None:
        from repro_torch.kernels import ops as kops
        sample = _kernel_sample_result(
            kops.sample_stats(sorted_rels, strata, b_i, b_max, seed + 1, expr))
    else:
        sample = sample_edges(sorted_rels, strata, b_i, b_max, seed + 1, f_fn)
    sync(sample.stats.sum_f.device)
    t2 = time.perf_counter()
    # --- stage 6: estimate + error bound (§3.4) ---
    value, err, cnt, dof = estimate_stage(sample, agg=agg, dedup=dedup,
                                          confidence=budget.confidence)
    sync(value.device)
    t3 = time.perf_counter()

    # --- feedback: store measured sigma for the next execution (§3.2-II) ---
    if sigma_registry is not None:
        sig = measured_sigma(sample.stats).cpu().numpy()
        ok = (sample.stats.valid & (sample.stats.n_sampled > 1)).cpu().numpy()
        sigma_registry.update(query_id, strata.keys.cpu().numpy(), sig, ok)

    return JoinResult(value, err, cnt, dof,
                      JoinDiagnostics(
                          sample_draws=sample.stats.n_sampled.sum(),
                          sampled=True, d_sample_s=t2 - t1,
                          d_estimate_s=t3 - t2, **diag),
                      stats=sample.stats, strata=strata)
