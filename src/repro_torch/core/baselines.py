"""The paper's comparison systems (§5/§6, Fig. 1) and its shuffle-volume
models (Appendix A.1, Eq. 18-26).

Implemented baselines:

* ``native_join``     — Spark RDD join: cogroup (no pre-filter) + full
                        cross-product.  Exact; meters the full shuffle and the
                        full cross-product op count.
* ``repartition_join``— hash-shuffle all tuples, local join.  Exact; the
                        ground truth of the accuracy gates.
* ``broadcast_join``  — smaller inputs replicated to every node.  Exact.
* ``prejoin_sampling``— Fig. 1 "sample inputs, then join": Bernoulli(p) per
                        input, join the samples, scale by p^-n.  Fast but
                        statistically broken for stratified outputs (loses
                        strata; variance blows up), reproduced on purpose.
* ``postjoin_sampling``— Fig. 1 "join, then sample": exact join materialized
                        (op count = full cross product), stratified sample of
                        the output.  Accurate but slow.

All return :class:`BaselineResult` carrying the estimate and the meters the
paper plots (shuffled bytes, cross-product ops) as 0-d tensors on the
relations' device.  The *volume models* are the closed-form Eq. 18-26.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.estimators import Estimate, clt_sum
from repro_torch.core.hashing import MASK, counter_hash
from repro_torch.core.join import EXPRS, TUPLE_BYTES
from repro_torch.core.relation import Relation, sort_by_key
from repro_torch.core.sampling import build_strata, exact_count, sample_edges


class BaselineResult(NamedTuple):
    estimate: torch.Tensor
    error_bound: torch.Tensor
    count: torch.Tensor              # join-output cardinality it processed
    shuffled_bytes: torch.Tensor     # modeled shuffle volume for this plan
    cross_product_ops: torch.Tensor  # pair evaluations performed


# --- Appendix A.1 closed-form shuffle-volume models (bytes) -----------------

def volume_broadcast(sizes_bytes: Sequence[float], k: int) -> float:
    """Eq. 18: all smaller inputs replicated to the k-1 other nodes."""
    smaller = sorted(sizes_bytes)[:-1]
    return float(sum(smaller) * (k - 1))


def volume_repartition(sizes_bytes: Sequence[float], k: int) -> float:
    """Eq. 21: every tuple moves with probability (k-1)/k."""
    return float(sum(sizes_bytes) * (k - 1) / k)


def volume_approxjoin(live_bytes: Sequence[float], filter_bytes: float,
                      k: int) -> float:
    """Eq. 24: n+1 filter broadcasts + only live tuples repartitioned."""
    n = len(live_bytes)
    return float(filter_bytes * (k - 1) * (n + 1)
                 + sum(live_bytes) * (k - 1) / k)


# --- exact baselines ---------------------------------------------------------

def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _exact(rels: Sequence[Relation], expr: str, max_strata=None):
    sorted_rels = [sort_by_key(r) for r in rels]
    strata = build_strata(sorted_rels, max_strata or rels[0].capacity)
    _, exact_fn = EXPRS[expr]
    return exact_fn(sorted_rels, strata), exact_count(strata), strata


def _shuffled(rels: Sequence[Relation], volume, k: int) -> torch.Tensor:
    sizes = [float(r.count()) * TUPLE_BYTES for r in rels]
    return _scalar(volume(sizes, max(k, 2)), rels[0].keys)


def native_join(rels: Sequence[Relation], *, expr: str = "sum",
                k: int = 1) -> BaselineResult:
    est, cnt, _ = _exact(rels, expr)
    return BaselineResult(est, torch.zeros_like(est), cnt,
                          _shuffled(rels, volume_repartition, k), cnt)


def repartition_join(rels: Sequence[Relation], *, expr: str = "sum",
                     k: int = 1) -> BaselineResult:
    est, cnt, _ = _exact(rels, expr)
    return BaselineResult(est, torch.zeros_like(est), cnt,
                          _shuffled(rels, volume_repartition, k), cnt)


def broadcast_join(rels: Sequence[Relation], *, expr: str = "sum",
                   k: int = 1) -> BaselineResult:
    est, cnt, _ = _exact(rels, expr)
    return BaselineResult(est, torch.zeros_like(est), cnt,
                          _shuffled(rels, volume_broadcast, k), cnt)


# --- sampling baselines (Fig. 1) ---------------------------------------------

def _keep_threshold(fraction: float) -> int:
    """The uint32 threshold a row's hash must stay below: fraction x
    (2^32 - 1), rounded through float32 and saturated at 2^32 - 1."""
    p = min(max(fraction, 0.0), 1.0) * 0xFFFFFFFF
    return min(int(np.float32(p)), MASK)


def prejoin_sampling(rels: Sequence[Relation], fraction: float, *,
                     expr: str = "sum", seed: int = 0,
                     k: int = 1) -> BaselineResult:
    """Sample each input Bernoulli(p), join the samples, scale by p^-n.

    This is the strategy the paper shows loses an order of magnitude of
    accuracy (Fig. 1): strata with few tuples vanish from the sample and the
    scale-up amplifies whatever survives.
    """
    p_u32 = _keep_threshold(fraction)
    sampled = []
    for i, r in enumerate(rels):
        rows = torch.arange(r.capacity, device=r.keys.device)
        keep = counter_hash(seed + 17 * i, r.keys, rows, 3) < p_u32
        sampled.append(Relation(r.keys, r.values, r.valid & keep))
    est, cnt, _ = _exact(sampled, expr)
    scale = (1.0 / max(fraction, 1e-9)) ** len(rels)
    return BaselineResult(est * scale, torch.zeros_like(est), cnt * scale,
                          _shuffled(sampled, volume_repartition, k), cnt)


def postjoin_sampling(rels: Sequence[Relation], fraction: float, *,
                      expr: str = "sum", seed: int = 0, b_max: int = 4096,
                      max_strata=None, k: int = 1,
                      confidence: float = 0.95) -> BaselineResult:
    """Exact join first, stratified sampleByKey after (Fig. 1 "accurate but
    slow"; also the SnappyData-shaped comparator of Fig. 12).

    Statistically equals the operator's sampler with b_i = s*B_i over
    unfiltered inputs; the meters tell the real story: full shuffle + full
    cross-product ops.
    """
    f_fn, _ = EXPRS[expr]
    sorted_rels = [sort_by_key(r) for r in rels]
    strata = build_strata(sorted_rels, max_strata or rels[0].capacity)
    b_i = torch.ceil(fraction * strata.population.to(torch.float32))
    sample = sample_edges(sorted_rels, strata, b_i, b_max, seed, f_fn)
    est: Estimate = clt_sum(sample.stats, confidence)
    cnt = exact_count(strata)
    # ops: the full cross product was materialized
    return BaselineResult(est.estimate, est.error_bound, cnt,
                          _shuffled(rels, volume_repartition, k), cnt)
