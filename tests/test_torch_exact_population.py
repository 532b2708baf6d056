"""Strata populations are exact int64 counts of join edges.

A stratum of 5,001 x 3,355 rows holds 16,778,355 edges, past float32's
exact integers (2^24): a float32 product reads 16,778,356.  The population
is the exact int64 product, and every consumer that computes in float32
casts it where it uses it, so the estimates and bounds of two-way joins stay
what the float32 product gave (a float32 product of two counts below 2^24
is the exact product, correctly rounded).  On the CPU (the kernel route's
plain versions)."""

import numpy as np
import pytest
import torch

from repro_torch.core.budget import QueryBudget
from repro_torch.core.estimators import clt_sum
from repro_torch.core.join import approx_join
from repro_torch.core.relation import relation, sort_by_key
from repro_torch.core.sampling import Strata, build_strata
from repro_torch.runtime.join_serve import JoinRequest, JoinServer
from repro_torch.runtime.telemetry import Tracer
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

BIG, SMALL = 5001, 3355          # 16,778,355 edges on key 7
EXACT = BIG * SMALL
S, B_MAX = 64, 256


def _pair(seed=0):
    """Key 7 with BIG rows on one side and SMALL on the other, a few small
    keys on both, and keys 50-54 of one edge each."""
    r = np.random.default_rng(seed)
    one = np.arange(50, 55)
    k1 = np.concatenate([np.full(BIG, 7), r.integers(20, 40, 300), one])
    k2 = np.concatenate([np.full(SMALL, 7), r.integers(20, 40, 200), one])
    return [relation(k.astype(np.uint32),
                     r.integers(1, 6, k.size).astype(np.float32),
                     device="cpu") for k in (k1, k2)]


def _float32_population(counts, joinable):
    """The population as a float32 product of the counts."""
    p = torch.prod(torch.clamp(counts, min=0).to(torch.float32), dim=0)
    return torch.where(joinable, p, 0.0)


def _stacked(strata):
    """Strata stacked slot by slot (``[B, ...]`` leaves), as a served
    step's prepare holds them."""
    return Strata(*(torch.stack(leaves) for leaves in zip(*strata)))


@pytest.mark.parametrize("slots", [None, 3], ids=["one", "stacked"])
def test_two_way_population_is_exact_int64(slots):
    """The population is the exact int64 product of the counts, for one
    slot's strata and for three slots stacked ``[B, n, S]``: there each
    slot's population, joinable mask and number of strata are what that
    slot's strata alone give, and so is its total."""
    assert np.float32(BIG) * np.float32(SMALL) == EXACT + 1
    each = [build_strata([sort_by_key(r) for r in _pair(seed)], S)
            for seed in range(slots or 1)]
    st = each[0] if slots is None else _stacked(each)
    assert st.population.dtype == torch.int64
    views = [(st.population, st.joinable, st.num_strata)] if slots is None \
        else list(zip(st.population, st.joinable, st.num_strata))
    for one, (pop, joinable, m) in zip(each, views, strict=True):
        i = int(torch.nonzero(one.keys == 7)[0, 0])
        assert int(pop[i]) == EXACT
        assert torch.equal(pop[~joinable], torch.zeros_like(pop[~joinable]))
        assert int(pop.sum()) == int((one.counts[0] * one.counts[1]
                                      * joinable).sum())
        assert torch.equal(pop, one.population)
        assert torch.equal(joinable, one.joinable)
        assert int(m) == int(one.num_strata)
    assert [int(t) for t in st.population.sum(-1).reshape(-1)] == \
        [int(one.population.sum()) for one in each]


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel"])
def test_estimate_and_bound_are_the_float32_products(use_kernels):
    """The sampled SUM and its bound, and the exact COUNT, equal what a
    float32 population gives, bit for bit; the stats carry the exact one."""
    res = approx_join(_pair(), QueryBudget(error=0.5), seed=11,
                      max_strata=S, b_max=B_MAX, use_kernels=use_kernels)
    st, strata = res.stats, res.strata
    assert st.population.dtype == torch.int64
    assert int(st.population.max()) == EXACT
    f32 = st._replace(population=_float32_population(strata.counts,
                                                     strata.joinable))
    want = clt_sum(f32)
    assert torch.equal(res.estimate, want.estimate)
    assert torch.equal(res.error_bound, want.error_bound)
    assert float(res.count) == float(f32.population.sum())
    ex = approx_join(_pair(), QueryBudget(), agg="count", max_strata=S,
                     use_kernels=use_kernels)
    assert float(ex.estimate) == float(f32.population.sum())
    assert int(ex.diagnostics.total_population) == int(st.population.sum())


def test_three_way_population_is_exact():
    counts = (263, 257, 251)
    prod = int(np.prod(counts))
    assert prod > 1 << 24
    assert float(np.float32(np.float32(263 * 257) * np.float32(251))) != prod
    rels = [relation(np.concatenate([np.full(c, 9), [30 + i]])
                     .astype(np.uint32), device="cpu")
            for i, c in enumerate(counts)]
    st = build_strata([sort_by_key(r) for r in rels], 8)
    pop = st.population
    assert pop.dtype == torch.int64
    assert int(pop[st.keys == 9][0]) == prod
    assert int(pop.sum()) == prod      # the other keys join nowhere


def _served(tracer, seeds=(2, 3)):
    """A kernel-route server of width 2 warmed by one pilot step, the tracer
    off; then one step of a request per seed, traced or not as ``tracer``
    was given, and those requests."""
    enabled, tracer.enabled = tracer.enabled, False
    srv = JoinServer(batch_slots=2, tracer=tracer)

    def req(seed, qid):
        return srv.submit(JoinRequest(
            rels=_pair(), budget=QueryBudget(error=0.5), query_id=qid,
            seed=seed, max_strata=S, b_max=B_MAX, use_kernels=True))
    req(1, "q0")
    req(1, "q1")
    srv.run()
    tracer.enabled = enabled
    reqs = [req(s, f"q{i}") for i, s in enumerate(seeds)]
    assert srv.step() == len(seeds)
    return srv, reqs


def test_served_population_crosses_as_float32_and_decide_counts_draws():
    """A traced kernel-route step copies the populations as float32 (4 bytes
    a stratum, as before), and its ``draws`` instant's ``draws``, ``full``
    and ``joinable`` are what the sampler drew over the joinable strata."""
    tr = Tracer(enabled=True)
    _, reqs = _served(tr)
    eng = [e for e in tr.events if e["tid"] == "engine"]
    pop = next(e for e in eng if e["name"] == "to-host"
               and e["args"]["what"] == "population")
    assert pop["args"]["bytes"] == 2 * S * 4
    counted = [e["args"] for e in eng if e["name"] == "draws"]
    assert len(counted) == 1
    draws = full = joinable = 0
    for r in reqs:
        st = r.result.stats
        ok = st.valid
        draws += int(st.n_sampled[ok].sum())
        full += int((st.n_sampled >= st.population)[ok].sum())
        joinable += int(ok.sum())
    assert (counted[0]["draws"], counted[0]["full"],
            counted[0]["joinable"]) == (draws, full, joinable)
    assert 0 < full < joinable


def test_untraced_decide_works_out_nothing_again(monkeypatch):
    """Untraced, a step records nothing, never reaches the trace's
    after-step work, and keeps no reference to the sampler's counts."""
    calls = []
    monkeypatch.setattr(JoinServer, "_trace_step",
                        lambda self, *a: calls.append(1))
    tr = Tracer(enabled=False)
    srv, reqs = _served(tr)
    assert all(r.done for r in reqs) and srv.sigma.has("q0")
    assert not calls and not tr.events and srv._draw_inputs is None


def test_draw_counts():
    """The ``draws`` event is an instant at its step's ``decide`` span, so
    no span nests it and the host's time a step (the step less its stages)
    is what it was; the after-step counts hold no tensors past the step."""
    tr = Tracer(enabled=True)
    srv, _ = _served(tr)
    eng = [e for e in tr.events if e["tid"] == "engine"]
    mark = next(e for e in eng if e["name"] == "draws")
    decide = next(e for e in eng if e["name"] == "decide")
    step = next(e for e in eng if e["name"] == "step")
    assert mark["dur"] is None and mark["ts"] == decide["ts"]
    assert step["ts"] <= mark["ts"] <= step["ts"] + step["dur"]
    assert "draws" not in decide["args"]
    assert srv._draw_inputs is None
