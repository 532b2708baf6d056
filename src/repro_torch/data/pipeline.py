"""LM training data pipeline with ApproxJoin as an input stage: the port of
the JAX package's ``data/pipeline.py``.

1. **Deterministic token source**: ``lm_batch(step, shard, ...)`` makes the
   (tokens, targets) pair of any (step, shard) from a counter-based hash of
   (seed, step, shard, position), on the device asked for.  No state and no
   files: any process can regenerate any shard, equal as integers to the
   reference's.

2. **ApproxJoin-weighted document selection**: a document table (doc id ->
   quality weight) is joined against a domain table (doc id -> domain tag)
   within an error budget; the per-stratum estimated mass decides how many
   sequences each domain contributes to a batch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.budget import QueryBudget
from repro_torch.core.hashing import MASK, counter_hash
from repro_torch.core.join import approx_join
from repro_torch.core.relation import Relation


def lm_batch(step: int, shard: int, *, batch: int, seq: int, vocab: int,
             seed: int = 0, structured: bool = False,
             device="cuda") -> dict:
    """Deterministic synthetic LM batch for (step, shard), int32 on
    ``device``.

    tokens[b, t] = counter_hash(seed, step * 2^16 + shard, b * (seq + 1) + t)
    % vocab; targets are tokens shifted left (next-token prediction).

    ``structured=True`` makes the stream learnable: an affine chain
    t_{i+1} = 3 t_i + 7 (mod vocab) with hash noise on 1/8 of positions.
    The reference scans the chain token by token; here each position's map
    (x -> 3x + 7, or a reset to its noise token) is composed with all the
    earlier ones by a prefix scan, log2(seq) steps of integer arithmetic
    mod ``vocab``, the same integers.
    """
    dev = torch.device(device)
    rows = torch.arange(batch, dtype=torch.int64, device=dev)[:, None]
    cols = torch.arange(seq + 1, dtype=torch.int64, device=dev)[None, :]
    stream = (int(step) * (1 << 16) + int(shard)) & MASK
    h = counter_hash(seed, stream, rows * (seq + 1) + cols, 7)
    if structured:
        start = counter_hash(seed, stream, rows, 8) % vocab        # [B, 1]
        reset = (h[:, 1:] & 7) == 0
        a = torch.where(reset, 0, 3)
        b = torch.where(reset, h[:, 1:] % vocab, 7)
        a, b = _compose_prefix(a, b, vocab)
        toks = torch.cat([start, (a * start + b) % vocab], dim=1)
    else:
        toks = h % vocab
    toks = toks.to(torch.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _compose_prefix(a: torch.Tensor, b: torch.Tensor, mod: int) -> tuple:
    """Inclusive prefix composition along dim 1 of the affine maps
    x -> a x + b (mod ``mod``): at t, the map of positions 0..t applied in
    order (Hillis-Steele; int64 products of values below ``mod``)."""
    T = a.shape[1]
    off = 1
    while off < T:
        a_hi, b_hi = a[:, off:], b[:, off:]
        a_lo, b_lo = a[:, :-off], b[:, :-off]
        a = torch.cat([a[:, :off], a_hi * a_lo % mod], dim=1)
        b = torch.cat([b[:, :off], (a_hi * b_lo + b_hi) % mod], dim=1)
        off *= 2
    return a, b


class MixturePlan(NamedTuple):
    domain_keys: np.ndarray      # uint32 [D] surviving domain ids
    weights: np.ndarray          # float32 [D] normalized mixing weights
    estimate: float              # aggregate estimate from the join
    error_bound: float


def plan_batch_mixture(doc_table: Relation, domain_table: Relation,
                       budget: QueryBudget = QueryBudget(error=0.05),
                       seed: int = 0, max_strata: int = 1024,
                       b_max: int = 512) -> MixturePlan:
    """ApproxJoin the doc-weight table with the domain table (on the
    tables' device); the per-stratum estimated mass becomes the batch
    mixing weights."""
    res = approx_join([domain_table, doc_table], budget, seed=seed,
                      max_strata=max_strata, b_max=b_max)
    strata = res.strata
    keys = strata.keys.cpu().numpy()
    if res.stats is not None:
        st = res.stats
        b = np.maximum(st.n_sampled.cpu().numpy(), 1.0)
        pop = st.population.float().cpu().numpy()
        mass = pop * st.sum_f.cpu().numpy() / b
        ok = st.valid.cpu().numpy()
    else:  # exact path: weight by stratum population
        mass = strata.population.float().cpu().numpy()
        ok = strata.joinable.cpu().numpy()
    mass = np.where(ok, np.maximum(mass, 0.0), 0.0)
    total = float(mass.sum()) or 1.0
    keep = ok & (mass > 0)
    return MixturePlan(keys[keep].astype(np.uint32),
                       (mass[keep] / total).astype(np.float32),
                       float(res.estimate), float(res.error_bound))


def mixture_shard_counts(plan: MixturePlan, batch: int,
                         seed: int = 0) -> np.ndarray:
    """Integerize mixing weights into per-domain sequence counts for a batch
    (largest-remainder rounding; deterministic)."""
    if len(plan.weights) == 0:
        return np.zeros((0,), np.int32)
    raw = plan.weights * batch
    base = np.floor(raw).astype(np.int32)
    rem = batch - int(base.sum())
    order = np.argsort(-(raw - base))
    base[order[:rem]] += 1
    return base
