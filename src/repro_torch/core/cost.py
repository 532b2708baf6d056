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


@dataclass
class SigmaRegistry:
    """Feedback store: per-(query, stratum-key) sigma estimates (§3.2-II).

    First execution -> no entry -> the caller falls back to a pilot fraction;
    after execution :meth:`update` records measured sigmas so later runs hit
    the error-bound target directly."""

    table: dict = field(default_factory=dict)

    def lookup(self, query_id: str, keys: np.ndarray,
               default: float = 1.0) -> np.ndarray:
        q = self.table.get(query_id, {})
        return np.asarray([q.get(int(k), default) for k in keys], np.float32)

    def has(self, query_id: str) -> bool:
        return query_id in self.table

    def update(self, query_id: str, keys, sigmas, valid) -> None:
        keys = np.asarray(keys)
        sigmas = np.asarray(sigmas)
        valid = np.asarray(valid)
        q = self.table.setdefault(query_id, {})
        for k, s, v in zip(keys, sigmas, valid):
            if v:
                q[int(k)] = float(s)

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
