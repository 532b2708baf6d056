"""Query-budget cost functions (paper §3.2).

Converts a user budget (desired latency or desired error bound) into
per-stratum sample sizes ``b_i``:

* latency:  Eq. 6/7.  ``s = (d_desired - d_dt - eps) / beta / sum_i B_i``,
  then ``b_i = s * B_i``.  ``beta_compute`` (seconds per sampled edge) is
  profiled offline with :func:`calibrate_beta` (the paper's Figure 5).

* error bound:  Eq. 9/10.  ``b_i = (z_{a/2} * sigma_i / err)^2``.  sigma_i is
  unknown on first execution; the feedback loop stores the measured
  per-stratum sigma in a :class:`SigmaRegistry` keyed by (query id, join key),
  JSON-persistable in the same format as the JAX implementation's, so a
  registry saved by one loads in the other.

Both paths are combined (Eq. 11) by the per-stratum minimum.
"""

from __future__ import annotations

import json
import time
from collections.abc import Mapping, MutableMapping
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.estimators import t_quantile

_F32 = torch.float32


class CostModel(NamedTuple):
    """Latency model d_cp = beta_compute * CP_total + epsilon (Eq. 5)."""

    beta_compute: float   # seconds per sampled cross-product row
    epsilon: float = 0.0  # fixed noise/overhead term


def sync(device) -> None:
    """Wait for the card, when ``device`` is one, before reading a host
    clock or a result."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def calibrate_beta(sizes=(1 << 14, 1 << 16, 1 << 18), repeats: int = 3,
                   seed: int = 0, device="cuda") -> CostModel:
    """Offline profiling (paper Fig. 5): time f-eval over N sampled edges
    for growing N on ``device`` and fit a line; the slope is beta."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []

    def work(a, b):
        return torch.sum(a + b) + torch.sum((a + b) ** 2)

    for n in sizes:
        a = torch.as_tensor(rng.random(n, np.float32), device=device)
        b = torch.as_tensor(rng.random(n, np.float32), device=device)
        work(a, b)  # warm-up
        sync(device)
        t0 = time.perf_counter()
        for _ in range(repeats):
            work(a, b)
        sync(device)
        xs.append(n)
        ys.append((time.perf_counter() - t0) / repeats)
    slope, intercept = np.polyfit(np.asarray(xs, np.float64),
                                  np.asarray(ys, np.float64), 1)
    return CostModel(float(max(slope, 1e-12)), float(max(intercept, 0.0)))


def calibrate_pipeline(rels, *, max_strata: int, b_max: int,
                       fractions=(0.05, 0.4), seed: int = 0) -> CostModel:
    """Two-point calibration against the real sampling pipeline: time the
    approx_join sampled path at two pilot fractions and fit
    d = beta * total_draws + eps."""
    from repro_torch.core.budget import QueryBudget
    from repro_torch.core.join import approx_join

    device = rels[0].keys.device
    pts = []
    for frac in fractions:
        kw = dict(max_strata=max_strata, b_max=None, seed=seed)
        approx_join(rels, QueryBudget(error=1e9, pilot_fraction=frac), **kw)
        sync(device)
        t0 = time.perf_counter()
        res = approx_join(rels, QueryBudget(error=1e9, pilot_fraction=frac),
                          **kw)
        sync(device)
        pts.append((float(res.diagnostics.sample_draws),
                    time.perf_counter() - t0))
    (x0, y0), (x1, y1) = pts
    beta = max((y1 - y0) / max(x1 - x0, 1.0), 1e-12)
    eps = max(y0 - beta * x0, 0.0)
    return CostModel(beta, eps)


def fraction_for_latency(cost: CostModel, d_desired: float, d_dt,
                         total_population) -> torch.Tensor:
    """Eq. 6: the sampling fraction affordable in the remaining time."""
    d_rem = max(d_desired - d_dt - cost.epsilon, 0.0)
    cp_total = torch.tensor(d_rem / cost.beta_compute, dtype=_F32)
    total = torch.as_tensor(total_population, dtype=_F32)
    s = cp_total.to(total.device) / torch.clamp(total, min=1.0)
    return torch.clamp(s, 0.0, 1.0)


def sizes_for_latency(cost: CostModel, d_desired: float, d_dt,
                      population) -> torch.Tensor:
    """Eq. 7: b_i = s * B_i (at least 1 draw for non-empty strata)."""
    population = torch.as_tensor(population, dtype=_F32)
    s = fraction_for_latency(cost, d_desired, d_dt, population.sum())
    b = torch.ceil(s * population)
    return torch.where(population > 0, torch.clamp(b, min=1.0), 0.0)


def sizes_for_error(err_desired: float, sigma, population,
                    confidence: float = 0.95) -> torch.Tensor:
    """Eq. 9/10: b_i = (z * sigma_i / err)^2, capped at B_i draws
    (beyond B_i with-replacement draws the FPC term is zero anyway)."""
    population = torch.as_tensor(population, dtype=_F32)
    sigma = torch.as_tensor(sigma, dtype=_F32, device=population.device)
    z = t_quantile(0.5 + confidence / 2.0, 1e6).to(population.device)
    b = torch.ceil((z * sigma / max(err_desired, 1e-12)) ** 2)
    b = torch.minimum(b, population)
    return torch.where(population > 0, torch.clamp(b, min=1.0), 0.0)


def predicted_latency(cost: CostModel, b_i, d_dt) -> torch.Tensor:
    """Eq. 5 forward model, for fidelity checks."""
    return cost.beta_compute * torch.as_tensor(b_i, dtype=_F32).sum() \
        + cost.epsilon + d_dt


_I64 = np.iinfo(np.int64)


class QuerySigmas(Mapping):
    """One query's sigmas as columns, read as ``{int key: float sigma}``.

    ``key_array`` (int64) and ``sigmas`` (float64, so a value set as a Python
    float reads back exactly) are in first-insertion order; ``sorted_keys``
    is the keys' sorted view and ``order`` its permutation into that order.
    Never changed in place: :meth:`merged` returns new columns, so a mapping
    read from :attr:`SigmaRegistry.table` keeps what it held."""

    def __init__(self, keys=(), sigmas=(), order=None, sorted_keys=None):
        self.key_array = np.asarray(keys, np.int64)
        self.sigmas = np.asarray(sigmas, np.float64)
        self.order = np.argsort(self.key_array, kind="stable") \
            if order is None else order
        self.sorted_keys = self.key_array[self.order] \
            if sorted_keys is None else sorted_keys

    @classmethod
    def of(cls, sigmas: Mapping) -> "QuerySigmas":
        """``sigmas`` ({int key: float}) as columns."""
        if isinstance(sigmas, QuerySigmas):
            return sigmas
        return cls([int(k) for k in sigmas],
                   [float(v) for v in sigmas.values()])

    def find(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Each int64 key's index in the columns, and whether it is there
        (the index of a missing key is any valid one)."""
        if not len(self.key_array):
            return (np.zeros(keys.shape, np.int64),
                    np.zeros(keys.shape, bool))
        pos = np.minimum(np.searchsorted(self.sorted_keys, keys),
                         len(self.sorted_keys) - 1)
        return self.order[pos], self.sorted_keys[pos] == keys

    def merged(self, keys: np.ndarray, sigmas: np.ndarray) -> "QuerySigmas":
        """These columns with each int64 key of ``keys`` set to its float64
        sigma (a key given twice takes its last): a stored key keeps its
        place, a new one goes after the stored ones in the order of its
        first occurrence."""
        if not len(keys):
            return self
        uniq, first = np.unique(keys, return_index=True)
        last = len(keys) - 1 - np.unique(keys[::-1], return_index=True)[1]
        at, hit = self.find(uniq)
        sig = self.sigmas.copy()
        sig[at[hit]] = sigmas[last[hit]]
        new = ~hit
        fresh, arrival = uniq[new], np.argsort(first[new])
        rank = np.empty(len(fresh), np.int64)
        rank[arrival] = np.arange(len(fresh))
        # ``fresh`` is sorted, so one insertion each merges the sorted view
        ins = np.searchsorted(self.sorted_keys, fresh)
        return QuerySigmas(
            np.concatenate([self.key_array, fresh[arrival]]),
            np.concatenate([sig, sigmas[last[new]][arrival]]),
            np.insert(self.order, ins, len(self.key_array) + rank),
            np.insert(self.sorted_keys, ins, fresh))

    def __getitem__(self, key) -> float:
        if isinstance(key, (int, np.integer)) and _I64.min <= key <= _I64.max:
            at, hit = self.find(np.asarray([key], np.int64))
            if hit[0]:
                return float(self.sigmas[at[0]])
        raise KeyError(key)

    def __iter__(self):
        return iter(self.key_array.tolist())

    def __len__(self) -> int:
        return len(self.key_array)

    def to_dict(self) -> dict:
        return dict(zip(self.key_array.tolist(), self.sigmas.tolist()))

    def items(self):
        return self.to_dict().items()

    def __repr__(self) -> str:
        return f"QuerySigmas({self.to_dict()!r})"


_NO_SIGMAS = QuerySigmas()


class SigmaTable(MutableMapping):
    """query id -> :class:`QuerySigmas`; a mapping ``{int key: float}`` set
    under a query id is stored as columns."""

    def __init__(self, tables: Mapping = ()):
        self._q: dict = {}
        self.update(tables)

    def __getitem__(self, query_id: str) -> QuerySigmas:
        return self._q[query_id]

    def __setitem__(self, query_id: str, sigmas: Mapping) -> None:
        self._q[query_id] = QuerySigmas.of(sigmas)

    def __delitem__(self, query_id: str) -> None:
        del self._q[query_id]

    def __iter__(self):
        return iter(self._q)

    def __len__(self) -> int:
        return len(self._q)

    def __repr__(self) -> str:
        return f"SigmaTable({self._q!r})"


@dataclass
class SigmaRegistry:
    """Feedback store: per-(query, stratum-key) sigma estimates (§3.2-II).

    First execution -> no entry -> the caller falls back to a pilot fraction;
    after execution :meth:`update` records measured sigmas so later runs hit
    the error-bound target directly.  Each query's sigmas are columns
    (:class:`QuerySigmas`), so a lookup or update over a request's strata is
    a few numpy calls."""

    table: Mapping = field(default_factory=dict)

    def __post_init__(self):
        self.table = SigmaTable(self.table)

    def lookup(self, query_id: str, keys: np.ndarray,
               default: float = 1.0) -> np.ndarray:
        return self.find(query_id, keys, default)[0]

    def find(self, query_id: str, keys: np.ndarray,
             default: float = 1.0) -> tuple[np.ndarray, int]:
        """:meth:`lookup`'s float32 sigmas (``default`` where a key has
        none), and how many keys had one."""
        keys = np.asarray(keys).astype(np.int64, copy=False)
        q = self.table.get(query_id, _NO_SIGMAS)
        at, hit = q.find(keys)
        sig = np.where(hit, q.sigmas[at], default) if len(q) \
            else np.full(keys.shape, default, np.float64)
        return sig.astype(np.float32), int(hit.sum())

    def has(self, query_id: str) -> bool:
        return query_id in self.table

    def update(self, query_id: str, keys, sigmas, valid) -> int:
        """Store each valid key's sigma (a key given twice keeps its last);
        returns how many keys were new to the query."""
        keys = np.asarray(keys)
        sigmas = np.asarray(sigmas)
        valid = np.asarray(valid)
        n = min(len(keys), len(sigmas), len(valid))
        ok = valid[:n].astype(bool)
        q = self.table.get(query_id, _NO_SIGMAS)
        self.table[query_id] = q.merged(keys[:n][ok].astype(np.int64),
                                        sigmas[:n][ok].astype(np.float64))
        return len(self.table[query_id]) - len(q)

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump({q: {str(k): v for k, v in t.items()}
                       for q, t in self.table.items()}, fh)

    @classmethod
    def load(cls, path: str) -> "SigmaRegistry":
        with open(path) as fh:
            raw = json.load(fh)
        return cls({q: {int(k): float(v) for k, v in t.items()}
                    for q, t in raw.items()})
