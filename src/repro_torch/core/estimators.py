"""Error estimation for sampled joins (paper §3.4).

* **CLT / stratified with-replacement** (Eq. 12-14): the edge sampler draws
  with replacement, so the stratified expansion estimator applies.
  ``tau_hat = sum_i (B_i / b_i) * sum_j v_ij`` with variance
  ``Var = sum_i B_i (B_i - b_i) r_i^2 / b_i`` and a t interval on
  ``f = sum_i b_i - m`` degrees of freedom.

* **Horvitz-Thompson** (Eq. 15-17): when duplicate edges are removed the
  draws are no longer i.i.d.; HT stays unbiased given the inclusion
  probabilities ``pi_i = 1 - (1 - 1/B_i)^{b_i}``.

The t quantile comes from the normal quantile (``torch.special.ndtri``) via
the Cornish-Fisher expansion.  Every function works on ``[S]`` tensors and
returns 0-d float32 tensors on their device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_F32 = torch.float32


def t_quantile(p, df):
    """Student-t quantile via Cornish-Fisher expansion around the normal.

    Accurate to ~1e-3 for df >= 3; df is clamped to 1 to stay finite when a
    query samples almost nothing.
    """
    df = torch.clamp(torch.as_tensor(df, dtype=_F32), min=1.0)
    z = torch.special.ndtri(torch.as_tensor(p, dtype=_F32, device=df.device))
    z3, z5, z7 = z**3, z**5, z**7
    g1 = (z3 + z) / 4.0
    g2 = (5.0 * z5 + 16.0 * z3 + 3.0 * z) / 96.0
    g3 = (3.0 * z7 + 19.0 * z5 + 17.0 * z3 - 15.0 * z) / 384.0
    return z + g1 / df + g2 / df**2 + g3 / df**3


class StratumStats(NamedTuple):
    """Per-stratum sufficient statistics emitted by the sampler.

    All tensors are [S] (or [B, S] for a batch); ``population`` is B_i, the
    join-output population of stratum i: the exact int64 product of the
    per-side counts, cast to float32 where an estimator computes with it.
    """

    valid: torch.Tensor       # bool [S]
    population: torch.Tensor  # i64  [S]  B_i
    n_sampled: torch.Tensor   # f32  [S]  b_i (actual draws)
    sum_f: torch.Tensor       # f32  [S]  sum of f(edge) over sample
    sum_f2: torch.Tensor      # f32  [S]  sum of f(edge)^2 over sample


class Estimate(NamedTuple):
    estimate: torch.Tensor     # point estimate of the population total
    error_bound: torch.Tensor  # half-width of the CI at the given confidence
    variance: torch.Tensor     # estimated Var(tau_hat)
    dof: torch.Tensor          # degrees of freedom used for the t interval

    @property
    def lo(self):
        return self.estimate - self.error_bound

    @property
    def hi(self):
        return self.estimate + self.error_bound


def _masked(x, valid):
    return torch.where(valid, x, 0.0)


def clt_sum(stats: StratumStats, confidence: float = 0.95) -> Estimate:
    """Paper Eq. 12-14: stratified expansion estimator for SUM."""
    return clt_finish(clt_sum_parts(stats), confidence)


class SumParts(NamedTuple):
    """Summable pieces of the CLT estimate: per-device parts over disjoint
    strata ADD, and ``clt_finish`` of the sum is the estimate over all."""

    tau: torch.Tensor       # sum_i B_i * mean_i
    var: torch.Tensor       # sum_i B_i (B_i - b_i) r_i^2 / b_i
    n_draws: torch.Tensor   # sum_i b_i
    m_strata: torch.Tensor  # number of contributing strata
    count: torch.Tensor     # sum_i B_i (exact join-output count)


def clt_sum_parts(stats: StratumStats) -> SumParts:
    ok = stats.valid & (stats.n_sampled > 0)
    b = torch.clamp(stats.n_sampled, min=1.0)
    B = stats.population.to(_F32)
    tau = _masked(B * stats.sum_f / b, ok).sum()
    var_ok = ok & (stats.n_sampled > 1)
    r2 = (stats.sum_f2 - stats.sum_f**2 / b) / torch.clamp(b - 1.0, min=1.0)
    r2 = torch.clamp(r2, min=0.0)
    fpc = torch.clamp(B - b, min=0.0)
    var = _masked(B * fpc * r2 / b, var_ok).sum()
    return SumParts(tau, var,
                    _masked(stats.n_sampled, ok).sum(),
                    ok.to(_F32).sum(),
                    _masked(B, stats.valid).sum())


def clt_finish(parts: SumParts, confidence: float = 0.95) -> Estimate:
    dof = torch.clamp(parts.n_draws - parts.m_strata, min=1.0)
    t = t_quantile(0.5 + confidence / 2.0, dof)
    return Estimate(parts.tau, t * torch.sqrt(parts.var), parts.var, dof)


def clt_count(stats: StratumStats) -> torch.Tensor:
    """COUNT of the join output given the strata: sum_i B_i, each exact
    int64 population cast to float32 and summed in float32."""
    return _masked(stats.population.to(_F32), stats.valid).sum()


def clt_avg_from(parts: SumParts, confidence: float = 0.95) -> Estimate:
    """AVG finish from summable parts (count is exact, CI just rescales)."""
    s = clt_finish(parts, confidence)
    n = torch.clamp(parts.count, min=1.0)
    return Estimate(s.estimate / n, s.error_bound / n, s.variance / n**2,
                    s.dof)


def clt_avg(stats: StratumStats, confidence: float = 0.95) -> Estimate:
    """AVG = SUM / COUNT (count is exact, so the CI just rescales)."""
    return clt_avg_from(clt_sum_parts(stats), confidence)


def inclusion_probability(population, n_sampled):
    """P(edge included at least once) under b_i with-replacement draws.

    Computed as -expm1(b * log1p(-1/B)): float32-stable for B up to 1e7+.
    """
    B = torch.clamp(torch.as_tensor(population, dtype=_F32), min=1.0)
    b = torch.as_tensor(n_sampled, dtype=_F32)
    return -torch.expm1(b * torch.log1p(-torch.clamp(1.0 / B, max=0.999999)))


class HTParts(NamedTuple):
    """Summable pieces of the Horvitz-Thompson estimate (Eq. 15-17)."""

    tau: torch.Tensor       # sum_i sum_{distinct e in i} f_e / pi_i
    var: torch.Tensor       # sum_i (1 - pi_i)/pi_i^2 * y_i^2
    m_strata: torch.Tensor  # number of contributing strata


def ht_sum_parts(stats: StratumStats, unique_f: torch.Tensor,
                 unique_counts: torch.Tensor) -> HTParts:
    ok = stats.valid & (unique_counts > 0)
    pi = inclusion_probability(stats.population, stats.n_sampled)
    pi = torch.where(ok, torch.clamp(pi, min=1e-9), 1.0)
    tau = _masked(unique_f / pi, ok).sum()
    # independent strata: only the first term of Eq. 17 survives across
    # strata; the per-stratum aggregate y_i is the HT unit
    var = _masked((1.0 - pi) / pi**2 * unique_f**2, ok).sum()
    return HTParts(tau, var, ok.to(_F32).sum())


def ht_finish(parts: HTParts, confidence: float = 0.95) -> Estimate:
    dof = torch.clamp(parts.m_strata - 1.0, min=1.0)
    t = t_quantile(0.5 + confidence / 2.0, dof)
    return Estimate(parts.tau, t * torch.sqrt(parts.var), parts.var, dof)


def horvitz_thompson_sum(stats: StratumStats, unique_f: torch.Tensor,
                         unique_counts: torch.Tensor,
                         confidence: float = 0.95) -> Estimate:
    """Paper Eq. 15-17 for the deduplicated sample: each distinct sampled
    edge contributes f_e / pi_i, with pi_i from :func:`inclusion_probability`.
    ``unique_f``/``unique_counts`` are [S] sums over the distinct edges."""
    return ht_finish(ht_sum_parts(stats, unique_f, unique_counts), confidence)


def second_moment_stats(stats: StratumStats) -> StratumStats:
    """Reuse the SUM machinery with f <- f^2 (feeds the STDEV estimator)."""
    return stats._replace(sum_f=stats.sum_f2,
                          sum_f2=torch.zeros_like(stats.sum_f2))


def clt_stdev_from(parts: SumParts, tau2: torch.Tensor,
                   confidence: float = 0.95) -> Estimate:
    """STDEV finish from summable parts plus the second-moment total."""
    n = torch.clamp(parts.count, min=1.0)
    s1 = clt_finish(parts, confidence)
    m1 = s1.estimate / n
    m2 = tau2 / n
    var = torch.clamp(m2 - m1 * m1, min=0.0)
    sd = torch.sqrt(var)
    # delta method: d(sd)/d(m1) = -m1/sd; propagate the SUM CI through m1
    dm1 = s1.error_bound / n
    bound = torch.where(sd > 0, torch.abs(m1) / torch.clamp(sd, min=1e-9) * dm1,
                        dm1)
    return Estimate(sd, bound, bound ** 2, s1.dof)


def clt_stdev(stats: StratumStats, confidence: float = 0.95) -> Estimate:
    """STDEV over the join output: sqrt(E[f^2] - E[f]^2), both moments by
    the stratified expansion estimator; the CI follows by the delta method."""
    return clt_stdev_from(clt_sum_parts(stats),
                          clt_sum_parts(second_moment_stats(stats)).tau,
                          confidence)


def accuracy_loss(approx, exact):
    """The paper's metric: (approx - exact) / exact (§5.1)."""
    exact = torch.where(exact == 0, 1.0, exact)
    return (approx - exact) / exact
