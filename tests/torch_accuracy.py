"""Statistical accuracy harness for the PyTorch port's ApproxJoin backends.

The counterpart of ``tests/accuracy.py`` for ``repro_torch``: the same
contract, the same seeded workloads and thresholds, with the port's exact
``repartition_join`` (``repro_torch/core/baselines.py``) as ground truth and
the port's ``overlapping_relations`` as data, made on the CPU.  What follows is the reference
harness's own description.

The bit-parity suite (tests/test_join_serve_distributed.py) proves the
expensive gather-merge serve path reproduces the single-device pipeline
float-for-float.  An *approximate* system's real contract is statistical —
"tight error bounds on the accuracy of the final results" — and that is the
only gate the cheap psum merge with capacity-planned buckets can pass.  This
harness states that contract once, for ANY backend:

Given R seeded replications over synthetic relations with known ground truth
(the exact ``repartition_join`` baseline from ``core/baselines.py``):

(a) **relative error within the CLT bound**: the mean relative error of the
    SUM estimate is dominated by the mean relative CLT half-width the
    backend reported (plus the per-replication check feeding (b));
(b) **CI coverage**: the reported ``[estimate ± error_bound]`` interval
    covers the truth in at least ``confidence - coverage_slack`` of the
    replications;
(c) **allocation-faithful draws**: realized per-stratum draw counts equal
    the stratified allocation ``min(max(ceil(s * B_i), 1), b_max)`` over
    joinable strata (skipped for backends that do not expose stats);
plus COUNT (exact given the strata) within ``count_rtol`` — the tolerance a
capacity-planned backend's counted drops must stay inside.

A backend is any ``fn(rels, seed) -> (estimate, error_bound, count, stats)``
with floats and an optional
:class:`~repro_torch.core.estimators.StratumStats`-like tuple (any slot
layout — canonical [S] or concatenated per-device [k*S];
the checks are per-stratum sums, layout-free).

:func:`run_stream_accuracy_gate` restates the same contract **per window**
for a streaming backend: every replication is one tumbling window delivered
as micro-batches, checked against the exact join of exactly that window's
tuples — so a window whose estimate leaked expired data, missed a
micro-batch, or reported a stale bound fails the gate the same way a biased
static backend does.  A stream backend is
``fn(micro_batches, w) -> (estimate, error_bound, count, stats)`` where
``micro_batches`` is a list of per-side Relation lists (``stats`` may be
None on windows whose allocation is sigma-fed rather than pilot-fed).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import pytest
import torch

from repro_torch.core.baselines import repartition_join
from repro_torch.core.relation import Relation
from repro_torch.data.synthetic import overlapping_relations


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's tests on one torch intra-op thread.  Imported by the
    port's CPU test modules: under pytest-xdist every worker process would
    otherwise start a thread per core, and their small ops then wait on
    each other (the three streaming-slice files took 121 s under 6 workers
    on 8 cores, and 26 s on one thread a worker)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclass(frozen=True)
class GateConfig:
    """Workload + thresholds of one accuracy-gate run.

    The defaults build joins with ~64 shared strata of ~8 rows per side
    (population B_i ~ 64), so the pilot allocation draws enough per stratum
    for the variance estimate to be real — a gate over strata with b_i = 1
    would be vacuous (zero estimated variance, exact-by-accident sampling).
    """

    replications: int = 30
    n_rows: int = 2048
    n_rels: int = 2            # inputs per join (3+ gates multi-way plans)
    keys_per_dataset: int = 256
    overlap: float = 0.25
    pilot_fraction: float = 0.1
    b_max: int = 256
    max_strata: int = 512
    confidence: float = 0.95
    coverage_slack: float = 0.05
    count_rtol: float = 1e-6
    seed: int = 0


@dataclass
class GateReport:
    """Everything the gate measured; ``failures`` empty == gate passed."""

    replications: int = 0
    coverage: float = 0.0
    nominal: float = 0.0
    mean_rel_err: float = 0.0
    mean_rel_bound: float = 0.0
    max_count_rel_err: float = 0.0
    alloc_mismatches: int = 0
    checked_allocation: bool = False
    failures: list = field(default_factory=list)

    @property
    def passed(self) -> bool:
        return not self.failures

    def summary(self) -> str:
        return (f"coverage {self.coverage:.3f} (nominal {self.nominal:.2f}), "
                f"rel err {self.mean_rel_err:.4f} vs CLT bound "
                f"{self.mean_rel_bound:.4f}, count rel err "
                f"{self.max_count_rel_err:.2e}, alloc mismatches "
                f"{self.alloc_mismatches} over {self.replications} reps"
                + ("" if self.passed else f" — FAILURES: {self.failures}"))


def expected_allocation(population: np.ndarray, pilot_fraction: float,
                        b_max: int) -> np.ndarray:
    """The §3.2-II pilot allocation the sampler must realize per stratum."""
    want = np.where(population > 0,
                    np.maximum(np.ceil(pilot_fraction * population), 1.0),
                    0.0)
    return np.minimum(want, float(b_max))


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


_TRUTH_CACHE: dict = {}


def _workload(cfg: GateConfig, r: int):
    """Replication r's relations + exact ground truth (truth memoized —
    several backends gate over the same seeded workloads)."""
    rels = overlapping_relations(
        [cfg.n_rows] * cfg.n_rels, cfg.overlap,
        keys_per_dataset=cfg.keys_per_dataset, seed=cfg.seed + r,
        device="cpu")
    key = (cfg.n_rows, cfg.n_rels, cfg.keys_per_dataset, cfg.overlap,
           cfg.seed + r)
    if key not in _TRUTH_CACHE:
        truth = repartition_join(rels, expr="sum")
        _TRUTH_CACHE[key] = (float(truth.estimate), float(truth.count))
    return rels, _TRUTH_CACHE[key]


class _Collector:
    """Accumulates per-replication measurements and applies the checks —
    shared by the static and per-window gates (one contract, two drivers)."""

    def __init__(self, pilot_fraction: float, b_max: int):
        self.pilot_fraction, self.b_max = pilot_fraction, b_max
        self.hits, self.n = 0, 0
        self.rel_errs, self.rel_bounds, self.count_errs = [], [], []
        self.alloc_bad, self.checked_alloc = 0, False

    def add(self, est, bound, cnt, stats, t_sum, t_cnt) -> None:
        self.n += 1
        self.hits += abs(est - t_sum) <= bound
        self.rel_errs.append(abs(est - t_sum) / max(abs(t_sum), 1e-9))
        self.rel_bounds.append(bound / max(abs(t_sum), 1e-9))
        self.count_errs.append(abs(cnt - t_cnt) / max(t_cnt, 1.0))
        if stats is not None:
            self.checked_alloc = True
            pop = _host(stats.population).astype(np.float64)
            drawn = np.where(_host(stats.valid),
                             _host(stats.n_sampled).astype(np.float64), 0.0)
            want = expected_allocation(pop, self.pilot_fraction, self.b_max)
            self.alloc_bad += int(np.sum(want != drawn))

    def report(self, confidence: float, coverage_slack: float,
               count_rtol: float) -> GateReport:
        rep = GateReport(
            replications=self.n,
            coverage=self.hits / max(self.n, 1),
            nominal=confidence,
            mean_rel_err=float(np.mean(self.rel_errs)),
            mean_rel_bound=float(np.mean(self.rel_bounds)),
            max_count_rel_err=float(np.max(self.count_errs)),
            alloc_mismatches=self.alloc_bad,
            checked_allocation=self.checked_alloc)
        if rep.coverage < confidence - coverage_slack:
            rep.failures.append(
                f"coverage {rep.coverage:.3f} < "
                f"{confidence - coverage_slack:.3f}")
        if rep.mean_rel_err > rep.mean_rel_bound:
            rep.failures.append(
                f"mean relative error {rep.mean_rel_err:.4f} exceeds the "
                f"mean CLT relative bound {rep.mean_rel_bound:.4f}")
        if rep.max_count_rel_err > count_rtol:
            rep.failures.append(
                f"count rel err {rep.max_count_rel_err:.2e} > {count_rtol}")
        if self.alloc_bad:
            rep.failures.append(
                f"{self.alloc_bad} strata drew != the stratified allocation")
        return rep


def run_accuracy_gate(backend, cfg: GateConfig = GateConfig()) -> GateReport:
    """Run R replications of ``backend`` against exact ground truth."""
    col = _Collector(cfg.pilot_fraction, cfg.b_max)
    for r in range(cfg.replications):
        rels, (t_sum, t_cnt) = _workload(cfg, r)
        est, bound, cnt, stats = backend(rels, cfg.seed + 7919 + r)
        col.add(est, bound, cnt, stats, t_sum, t_cnt)
    return col.report(cfg.confidence, cfg.coverage_slack, cfg.count_rtol)


# ---------------------------------------------------------------------------
# Per-window gate for streaming backends: each replication is one tumbling
# window delivered as micro-batches; truth is the exact join of exactly that
# window's tuples (so leaked expired data or a missed micro-batch fails).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StreamGateConfig:
    """Workload + thresholds of one per-window accuracy-gate run."""

    windows: int = 12          # replications (one per tumbling window)
    window_size: int = 4       # micro-batches (sub-windows) per window
    rows_per_window: int = 2048
    keys_per_dataset: int = 256
    overlap: float = 0.25
    pilot_fraction: float = 0.1
    b_max: int = 256
    max_strata: int = 512
    confidence: float = 0.95
    coverage_slack: float = 0.05
    count_rtol: float = 1e-6
    seed: int = 0

    @property
    def rows_per_sub(self) -> int:
        assert self.rows_per_window % self.window_size == 0
        return self.rows_per_window // self.window_size


def stream_window_workload(cfg: StreamGateConfig, w: int):
    """Window w's micro-batch stream + its exact ground truth.

    The window's relations are drawn like the static gate's (fresh keys and
    values per window — independent replications), then sliced into
    ``window_size`` per-side micro-batches; the streaming engine must
    reassemble exactly this window.
    """
    rels = overlapping_relations(
        [cfg.rows_per_window] * 2, cfg.overlap,
        keys_per_dataset=cfg.keys_per_dataset, seed=cfg.seed + w,
        device="cpu")
    rs = cfg.rows_per_sub
    mbs = [[Relation(r.keys[m * rs:(m + 1) * rs],
                     r.values[m * rs:(m + 1) * rs],
                     r.valid[m * rs:(m + 1) * rs]) for r in rels]
           for m in range(cfg.window_size)]
    key = ("stream", cfg.rows_per_window, cfg.keys_per_dataset, cfg.overlap,
           cfg.seed + w)
    if key not in _TRUTH_CACHE:
        truth = repartition_join(rels, expr="sum")
        _TRUTH_CACHE[key] = (float(truth.estimate), float(truth.count))
    return mbs, _TRUTH_CACHE[key]


def run_stream_accuracy_gate(stream_backend,
                             cfg: StreamGateConfig = StreamGateConfig()
                             ) -> GateReport:
    """Per-window statistical contract of a streaming join backend."""
    col = _Collector(cfg.pilot_fraction, cfg.b_max)
    for w in range(cfg.windows):
        mbs, (t_sum, t_cnt) = stream_window_workload(cfg, w)
        est, bound, cnt, stats = stream_backend(mbs, w)
        col.add(est, bound, cnt, stats, t_sum, t_cnt)
    return col.report(cfg.confidence, cfg.coverage_slack, cfg.count_rtol)
