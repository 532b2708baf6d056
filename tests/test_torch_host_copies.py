"""What a served step copies to the host, on the CPU, on the plain and the
kernel route: every step copies each slot's exact total population (8 bytes
a slot); only a step holding a request that is not exact also copies the
``[B, S]`` strata populations and keys.  Exact answers stay bit for bit the
port's own ``approx_join``'s, alone or beside a sampled request, traced or
not; a sampled answer and its SigmaRegistry are those of a sequential
``approx_join`` driver; a latency budget takes approx_join's path."""

import numpy as np
import pytest
import torch

from repro_torch.core.budget import QueryBudget
from repro_torch.core.cost import CostModel, SigmaRegistry
from repro_torch.core.join import approx_join
from repro_torch.core.relation import relation
from repro_torch.runtime.join_serve import JoinRequest, JoinServer
from repro_torch.runtime.telemetry import Tracer, span_tree
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

MS, BM = 512, 256   # max_strata / b_max used throughout
ERR = QueryBudget(error=0.5)
EXACT = QueryBudget()
ROUTES = pytest.mark.parametrize("use_kernels", [False, True],
                                 ids=["plain", "kernel"])
AGGS = pytest.mark.parametrize("agg", ["sum", "count", "avg"])


def _pair(seed, n=1 << 10):
    r = np.random.default_rng(seed)
    return [relation(r.integers(0, 200, n).astype(np.uint32),
                     r.normal(10, 2, n).astype(np.float32), device="cpu"),
            relation(r.integers(150, 350, n).astype(np.uint32),
                     r.normal(5, 1, n).astype(np.float32), device="cpu")]


def _req(seed, budget, use_kernels, qid=None, agg="sum"):
    return JoinRequest(rels=_pair(seed), budget=budget, agg=agg,
                       query_id=qid or f"q{seed}", seed=seed, max_strata=MS,
                       b_max=BM, use_kernels=use_kernels)


def _direct(seed, budget, use_kernels, agg="sum", **kw):
    return approx_join(_pair(seed), budget, agg=agg, seed=seed,
                       max_strata=MS, b_max=BM, use_kernels=use_kernels, **kw)


def _bits(res):
    return [float(getattr(res, f))
            for f in ("estimate", "error_bound", "count", "dof")]


def _steps(tr):
    return [n for n in span_tree(e for e in tr.events if e["tid"] == "engine")
            if n["name"] == "step"]


def _copies(step):
    """The ``to-host`` spans a step makes, its sampled requests' included."""
    return [g["args"] for c in step["children"] for g in [c] + c["children"]
            if g["name"] == "to-host"]


def _slots(step):
    return next(c["args"]["slots"] for c in step["children"]
                if c["name"] == "batch-inputs")


@ROUTES
@AGGS
def test_exact_step_copies_only_the_totals(use_kernels, agg):
    """A traced step of exact requests alone makes one copy to the host:
    each slot's total population, 8 bytes a slot, pad slots included; every
    answer is bit for bit approx_join's."""
    tr = Tracer(enabled=True)
    srv = JoinServer(batch_slots=4, tracer=tr)
    seeds = (11, 12, 13)
    qs = [srv.submit(_req(s, EXACT, use_kernels, agg=agg)) for s in seeds]
    assert srv.step() == 3
    step, = _steps(tr)
    B = _slots(step)
    assert B == 4
    assert _copies(step) == [{"bytes": 8 * B, "what": "totals"}]
    for q, s in zip(qs, seeds):
        direct = _direct(s, EXACT, use_kernels, agg=agg)
        assert not bool(q.result.diagnostics.sampled)
        assert _bits(q.result) == _bits(direct), s
        assert int(q.result.diagnostics.total_population) == \
            int(direct.diagnostics.total_population)


@ROUTES
@AGGS
def test_exact_answers_keep_their_bits_beside_a_sampled_request(use_kernels,
                                                                agg):
    """An exact request served beside a sampled one (whose step copies the
    populations and keys) gets the bits it gets in a step of exact requests
    alone."""
    alone = JoinServer(batch_slots=4)
    a = alone.submit(_req(21, EXACT, use_kernels, agg=agg))
    assert alone.step() == 1
    mixed = JoinServer(batch_slots=4)
    b = mixed.submit(_req(21, EXACT, use_kernels, agg=agg))
    s = mixed.submit(_req(22, ERR, use_kernels, agg=agg))
    assert mixed.step() == 2
    assert bool(s.result.diagnostics.sampled)
    assert not bool(b.result.diagnostics.sampled)
    assert _bits(a.result) == _bits(b.result)
    assert _bits(b.result) == _bits(_direct(21, EXACT, use_kernels, agg=agg))


@ROUTES
def test_mixed_step_copies_all_and_samples_as_before(use_kernels):
    """A step of a sampled and an exact request copies the totals, the
    populations and the strata keys; the sampled answer and the registry's
    sigmas are those of approx_join driven in sequence with its own
    registry."""
    tr = Tracer(enabled=False)
    srv = JoinServer(batch_slots=2, tracer=tr)
    srv.submit(_req(31, ERR, use_kernels, qid="t0"))
    srv.run()
    tr.enabled = True
    a = srv.submit(_req(32, ERR, use_kernels, qid="t0"))
    b = srv.submit(_req(33, EXACT, use_kernels))
    assert srv.step() == 2
    step, = _steps(tr)
    B = _slots(step)
    S = a.result.strata.keys.shape[0]
    copies = [(c["what"], c["bytes"]) for c in _copies(step)]
    assert copies[:3] == [("totals", 8 * B), ("population", B * S * 4),
                          ("strata-keys", B * S * 8)]
    assert [w for w, _ in copies[3:]] == ["sigma"]
    reg = SigmaRegistry()
    _direct(31, ERR, use_kernels, sigma_registry=reg, query_id="t0")
    direct = _direct(32, ERR, use_kernels, sigma_registry=reg, query_id="t0")
    assert bool(a.result.diagnostics.sampled)
    assert _bits(a.result) == _bits(direct)
    for f in ("n_sampled", "sum_f", "sum_f2"):
        assert torch.equal(getattr(a.result.stats, f),
                           getattr(direct.stats, f)), f
    assert dict(srv.sigma.table["t0"].items()) == \
        dict(reg.table["t0"].items())
    assert _bits(b.result) == _bits(_direct(33, EXACT, use_kernels))


@ROUTES
@pytest.mark.parametrize("side", [-1, 1], ids=["sampled", "exact"])
def test_latency_budget_decides_from_the_exact_total(use_kernels, side):
    """A latency budget well below or above the exact path's cost (an
    ``epsilon`` of seconds, so the timed filtering stage does not move the
    decision) takes approx_join's path, and its step copies the populations
    and keys a sampled request reads."""
    total = int(_direct(41, EXACT, use_kernels).diagnostics.total_population)
    assert total > 0
    cost = CostModel(beta_compute=1.0 / total, epsilon=5.0)  # exact: 6 s
    budget = QueryBudget(latency_s=6.0 + 3.0 * side)
    tr = Tracer(enabled=True)
    srv = JoinServer(batch_slots=2, tracer=tr, cost_model=cost)
    q = srv.submit(_req(41, budget, use_kernels))
    assert srv.step() == 1
    direct = _direct(41, budget, use_kernels, cost_model=cost)
    sampled = side < 0
    assert bool(direct.diagnostics.sampled) == sampled
    assert bool(q.result.diagnostics.sampled) == sampled
    step, = _steps(tr)
    assert [c["what"] for c in _copies(step)][:3] == [
        "totals", "population", "strata-keys"]
    if not sampled:
        assert _bits(q.result) == _bits(direct)


@ROUTES
def test_untraced_exact_step_serves_the_traced_bits(use_kernels,
                                                    monkeypatch):
    """Untraced, a step of exact requests copies the live rows a side that
    its sorts take (one ``[n_real, 2]`` tensor on the kernel route, one
    ``[2]`` a slot on the plain route, in the warm-up's prepare and in the
    step's) and the totals (one ``[B]`` tensor),
    and serves the bits a traced step serves."""
    on = JoinServer(batch_slots=4, tracer=Tracer(enabled=True))
    off = JoinServer(batch_slots=4)
    seeds = (51, 52)
    traced = [on.submit(_req(s, EXACT, use_kernels)) for s in seeds]
    assert on.step() == 2
    plain = [off.submit(_req(s, EXACT, use_kernels)) for s in seeds]
    copies = []
    cpu = torch.Tensor.cpu

    def counted(t, *a, **k):
        copies.append((tuple(t.shape), t.dtype))
        return cpu(t, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    assert off.step() == 2
    monkeypatch.undo()
    # the live rows, read by the width's first prepare (its warm-up) and
    # by the step's
    live = ([(2, 2)] if use_kernels else [(2,), (2,)]) * 2
    assert copies == [(shape, torch.int64) for shape in live + [(2,)]]
    assert not off.tracer.events
    for x, y in zip(traced, plain):
        assert _bits(x.result) == _bits(y.result)
