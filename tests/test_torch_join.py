"""PyTorch port vs the JAX package: strata, exact aggregates, cost functions
and ``approx_join`` end to end on the CPU.

The same numpy relations go through ``repro.core.join.approx_join`` and
``repro_torch.core.join.approx_join``.  Integer outputs (strata, counts, draw
counts) must be equal; estimates and error bounds within rtol 1e-4, because
float32 sums over the strata run in another order."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.relation  # noqa: F401  (repro.core re-exports a function so named)
from repro.core import cost as jcost
from repro.core import join as jjoin
from repro.core import sampling as jsamp
from repro.core.budget import QueryBudget as JBudget
from repro_torch.core import cost as tcost
from repro_torch.core import join as tjoin
from repro_torch.core import relation as trel
from repro_torch.core import sampling as tsamp
from repro_torch.core.budget import QueryBudget as TBudget
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

jrel = sys.modules["repro.core.relation"]


def _arrays(seed, n=4096, spans=((0, 500), (400, 900), (450, 1000)),
            mus=(10.0, 5.0, 3.0), invalid=0.1):
    rng = np.random.default_rng(seed)
    out = []
    for (lo, hi), mu in zip(spans, mus):
        k = (rng.integers(lo, hi, n) * 2654435761 % 2**32).astype(np.uint32)
        v = rng.normal(mu, 2, n).astype(np.float32)
        out.append((k, v, rng.random(n) > invalid))
    return out


def _pair(seed, ways=2, **kw):
    arrs = _arrays(seed, **kw)[:ways]
    return ([jrel.relation(*a) for a in arrs],
            [trel.from_numpy(*a, device="cpu") for a in arrs])


def _f(x):
    return float(np.asarray(x))


def _same_result(rj, rt, rtol=1e-4):
    np.testing.assert_allclose(_f(rt.estimate), _f(rj.estimate), rtol=rtol)
    np.testing.assert_allclose(_f(rt.error_bound), _f(rj.error_bound),
                               rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(_f(rt.count), _f(rj.count), rtol=1e-6)
    dj, dt = rj.diagnostics, rt.diagnostics
    assert dj.sampled == dt.sampled
    for name in ("total_counts", "live_counts", "num_strata",
                 "strata_overflow", "shuffled_bytes_filtered",
                 "shuffled_bytes_repartition", "sample_draws"):
        np.testing.assert_array_equal(np.asarray(getattr(dj, name)),
                                      getattr(dt, name).numpy(), err_msg=name)
    assert dj.filter_bytes == dt.filter_bytes


def test_build_strata_and_value_sums_match():
    (j1, j2), (t1, t2) = _pair(0)
    js = [jrel.sort_by_key(r) for r in (j1, j2)]
    ts = [trel.sort_by_key(r) for r in (t1, t2)]
    for S in (1024, 64):  # 64 < distinct keys: exercises the overflow row
        jst, tst = jsamp.build_strata(js, S), tsamp.build_strata(ts, S)
        for name in ("keys", "valid", "starts", "counts", "overflow"):
            np.testing.assert_array_equal(
                np.asarray(getattr(jst, name)).astype(np.int64),
                getattr(tst, name).numpy().astype(np.int64), err_msg=name)
        np.testing.assert_array_equal(np.asarray(jst.population),
                                      tst.population.numpy())
        np.testing.assert_allclose(
            np.asarray(jsamp.per_stratum_value_sums(js, jst)),
            tsamp.per_stratum_value_sums(ts, tst).numpy(), rtol=1e-5)
        for fn in ("exact_sum_of_sums", "exact_sum_of_products"):
            np.testing.assert_allclose(_f(getattr(jsamp, fn)(js, jst)),
                                       _f(getattr(tsamp, fn)(ts, tst)),
                                       rtol=1e-5)


@pytest.mark.parametrize("expr", ["sum", "product"])
@pytest.mark.parametrize("budget", ["exact", "error"])
def test_approx_join_matches_reference(expr, budget):
    js, ts = _pair(1)
    for agg in ("sum", "count", "avg", "stdev"):
        if agg == "stdev" and budget == "exact":
            continue  # no exact STDEV path in either package
        kw = dict(agg=agg, expr=expr, seed=3, max_strata=1024, b_max=128)
        jb, tb = ((JBudget(), TBudget()) if budget == "exact"
                  else (JBudget(error=0.5), TBudget(error=0.5)))
        _same_result(jjoin.approx_join(js, jb, **kw),
                     tjoin.approx_join(ts, tb, **kw))


def test_approx_join_dedup_and_three_way_match_reference():
    js, ts = _pair(2)
    kw = dict(seed=4, max_strata=1024, b_max=128)
    _same_result(jjoin.approx_join(js, JBudget(error=0.5), dedup=True, **kw),
                 tjoin.approx_join(ts, TBudget(error=0.5), dedup=True, **kw))
    js3, ts3 = _pair(3, ways=3)
    for jb, tb in ((JBudget(), TBudget()),
                   (JBudget(error=0.5), TBudget(error=0.5))):
        _same_result(jjoin.approx_join(js3, jb, **kw),
                     tjoin.approx_join(ts3, tb, **kw))


@pytest.mark.parametrize("expr", ["sum", "product"])
def test_approx_join_kernel_branch_matches_reference(expr):
    """use_kernels=True: the port's kernel wrappers (plain versions on CPU
    tensors) against the JAX package's Pallas path in interpret mode."""
    js, ts = _pair(5)
    kw = dict(expr=expr, seed=6, max_strata=1024, b_max=128, use_kernels=True)
    for jb, tb in ((JBudget(), TBudget()),
                   (JBudget(error=0.5), TBudget(error=0.5))):
        rj, rt = jjoin.approx_join(js, jb, **kw), tjoin.approx_join(ts, tb, **kw)
        _same_result(rj, rt)
        plain = tjoin.approx_join(ts, tb, **{**kw, "use_kernels": False})
        assert _f(plain.estimate) == _f(rt.estimate)
        if rj.stats is not None:
            np.testing.assert_array_equal(np.asarray(rj.stats.n_sampled),
                                          rt.stats.n_sampled.numpy())


def test_sigma_registry_crosses_and_feeds_back(tmp_path):
    """A registry saved by the JAX package loads in the port with the same
    table, and the second (sigma-driven) run then matches too."""
    js, ts = _pair(7)
    kw = dict(seed=8, max_strata=1024, b_max=128, query_id="q")
    jreg = jcost.SigmaRegistry()
    jjoin.approx_join(js, JBudget(error=0.2), sigma_registry=jreg, **kw)
    path = tmp_path / "sigma.json"
    jreg.save(str(path))
    treg = tcost.SigmaRegistry.load(str(path))
    assert treg.table == jreg.table and treg.table["q"]
    treg.save(str(tmp_path / "back.json"))
    assert (tmp_path / "back.json").read_bytes() == path.read_bytes()
    treg2 = tcost.SigmaRegistry()
    tjoin.approx_join(ts, TBudget(error=0.2), sigma_registry=treg2, **kw)
    assert treg2.table.keys() == jreg.table.keys()
    assert treg2.table["q"].keys() == jreg.table["q"].keys()
    np.testing.assert_allclose(
        [treg2.table["q"][k] for k in sorted(jreg.table["q"])],
        [jreg.table["q"][k] for k in sorted(jreg.table["q"])], rtol=1e-5)
    _same_result(
        jjoin.approx_join(js, JBudget(error=0.2), sigma_registry=jreg, **kw),
        tjoin.approx_join(ts, TBudget(error=0.2), sigma_registry=treg, **kw))


def test_cost_functions_match_reference():
    rng = np.random.default_rng(9)
    pop = np.where(rng.random(300) > 0.2, rng.integers(1, 5000, 300),
                   0).astype(np.float32)
    sigma = rng.uniform(0.1, 5, 300).astype(np.float32)
    cm = (1e-7, 1e-3)
    for err in (0.05, 1.0):
        np.testing.assert_array_equal(
            np.asarray(jcost.sizes_for_error(err, sigma, jnp.asarray(pop))),
            tcost.sizes_for_error(err, sigma, torch.as_tensor(pop)).numpy())
    jl = jcost.sizes_for_latency(jcost.CostModel(*cm), 0.5, 0.01,
                                 jnp.asarray(pop))
    tl = tcost.sizes_for_latency(tcost.CostModel(*cm), 0.5, 0.01,
                                 torch.as_tensor(pop))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-5)
    np.testing.assert_allclose(
        _f(jcost.predicted_latency(jcost.CostModel(*cm), jl, 0.01)),
        _f(tcost.predicted_latency(tcost.CostModel(*cm), tl, 0.01)),
        rtol=1e-5)


def test_latency_budget_and_calibration_run_on_cpu():
    _, ts = _pair(10)
    cm = tcost.calibrate_beta(sizes=(1 << 10, 1 << 12), repeats=1,
                              device="cpu")
    assert cm.beta_compute > 0
    res = tjoin.approx_join(ts, TBudget(latency_s=1e3), cost_model=cm,
                            max_strata=1024, b_max=128)
    assert res.diagnostics.sampled is False  # everything is affordable
    res = tjoin.approx_join(ts, TBudget(latency_s=1e-9, error=0.5),
                            cost_model=cm, max_strata=1024, b_max=128)
    assert res.diagnostics.sampled is True
    cal = tcost.calibrate_pipeline(ts, max_strata=1024, b_max=128)
    assert cal.beta_compute > 0


def test_batched_stages_equal_single_query_stages():
    """The slot-batched kernel stages (B = 3, mixed seeds) equal the
    single-query stages slot by slot."""
    from repro_torch.kernels import ops as tops
    from repro_torch.core.bloom import num_blocks_for
    B, S, nb, b_max = 3, 512, num_blocks_for(4096, 0.01), 64
    seeds = [0, 2**32 - 1, 77]
    slots = [_pair(20 + b)[1] for b in range(B)]
    rels = [trel.Relation(*(torch.stack([s[i][f] for s in slots])
                            for f in range(3))) for i in range(2)]
    words = torch.stack([torch.stack([tops.build_filter(r.keys, r.valid, nb,
                                                        seeds[b]).words
                                      for r in slots[b]])
                         for b in range(B)])
    prep = tjoin.prepare_stage_kernels_batched(rels, words, S,
                                               torch.tensor(seeds))
    b_i = torch.full((B, S), 40.0)
    out = tjoin.sample_stage_kernels_batched(prep.sorted_rels, prep.strata,
                                             b_i, b_max, torch.tensor(seeds))
    for b in range(B):
        one = tjoin.prepare_stage_kernels(slots[b], nb, S, seeds[b])
        for x, y in zip(tjoin._slot(prep.strata, b), one.strata):
            assert torch.equal(x, y)
        assert torch.equal(prep.live_counts[b], one.live_counts)
        single = tjoin.sample_stage_kernels(one.sorted_rels, one.strata,
                                            b_i[b], b_max, seeds[b])
        for x, y in zip(out[:4], single[:4]):
            assert torch.equal(x[b], y)
