"""The port's baselines, volume models and data generators against the JAX
package's on the CPU.

Integers (counts, cross-product ops, shuffled bytes, keys, validity) must be
equal; the generators' float32 values equal too (the same numpy draws);
estimates and error bounds within rtol 1e-5, because float32 sums over the
strata run in another order."""

import sys

import numpy as np
import pytest

import repro.core.relation  # noqa: F401  (repro.core re-exports a function so named)
from repro.core import baselines as jb
from repro.core import join as jjoin
from repro.core.budget import QueryBudget as JBudget
from repro.data import flows as jflows
from repro.data import netflix as jnetflix
from repro.data import tpch as jtpch
from repro_torch.core import baselines as tb
from repro_torch.core import join as tjoin
from repro_torch.core.budget import QueryBudget
from repro_torch.core.relation import from_numpy
from repro_torch.data import flows as tflows
from repro_torch.data import netflix as tnetflix
from repro_torch.data import tpch as ttpch
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

jrel = sys.modules["repro.core.relation"]


def _pair(seed, n=3000, invalid=0.1):
    rng = np.random.default_rng(seed)
    arrs = [(rng.integers(lo, hi, n).astype(np.uint32),
             rng.normal(mu, 2, n).astype(np.float32), rng.random(n) > invalid)
            for lo, hi, mu in ((0, 400, 10.0), (300, 700, 4.0))]
    return ([jrel.relation(*a) for a in arrs],
            [from_numpy(*a, device="cpu") for a in arrs])


def _same_baseline(rj, rt, rtol=1e-5):
    np.testing.assert_allclose(float(rt.estimate), float(rj.estimate),
                               rtol=rtol)
    np.testing.assert_allclose(float(rt.error_bound), float(rj.error_bound),
                               rtol=rtol)
    for f in ("count", "shuffled_bytes", "cross_product_ops"):
        assert float(getattr(rt, f)) == float(getattr(rj, f)), f


@pytest.mark.parametrize("expr", ["sum", "product"])
@pytest.mark.parametrize("name", ["native_join", "repartition_join",
                                  "broadcast_join"])
def test_exact_baselines_match_jax(name, expr):
    rj, rt = _pair(1)
    _same_baseline(getattr(jb, name)(rj, expr=expr, k=4),
                   getattr(tb, name)(rt, expr=expr, k=4))


@pytest.mark.parametrize("fraction", [0.1, 0.5, 1.0])
def test_prejoin_sampling_matches_jax(fraction):
    """The Bernoulli keep test is integer hashing against a uint32
    threshold, so the same rows survive on both sides (1.0 saturates)."""
    rj, rt = _pair(2)
    _same_baseline(jb.prejoin_sampling(rj, fraction, seed=5, k=3),
                   tb.prejoin_sampling(rt, fraction, seed=5, k=3))


@pytest.mark.parametrize("expr", ["sum", "product"])
def test_postjoin_sampling_matches_jax(expr):
    rj, rt = _pair(3)
    a = jb.postjoin_sampling(rj, 0.2, expr=expr, seed=9, b_max=64)
    b = tb.postjoin_sampling(rt, 0.2, expr=expr, seed=9, b_max=64)
    _same_baseline(a, b)
    assert float(b.error_bound) > 0


@pytest.mark.parametrize("k", [1, 2, 8])
def test_volume_models_match_jax(k):
    sizes = [8.0e6, 1.5e5, 3.2e7]
    assert tb.volume_broadcast(sizes, k) == jb.volume_broadcast(sizes, k)
    assert tb.volume_repartition(sizes, k) == jb.volume_repartition(sizes, k)
    assert tb.volume_approxjoin(sizes[:2], 4096.0, k) \
        == jb.volume_approxjoin(sizes[:2], 4096.0, k)


def _same_relations(js, ts):
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a.keys).astype(np.int64),
                                      b.keys.numpy())
        np.testing.assert_array_equal(np.asarray(a.values), b.values.numpy())
        np.testing.assert_array_equal(np.asarray(a.valid), b.valid.numpy())


def test_tpch_tables_and_query_cores_match_jax():
    tj, tt = jtpch.generate(0.002, seed=4), ttpch.generate(0.002, seed=4)
    for a, b in zip(tj, tt):
        np.testing.assert_array_equal(a, b)
    _same_relations(jtpch.q_customer_orders(tj),
                    ttpch.q_customer_orders(tt, device="cpu"))
    _same_relations(jtpch.q4_core(tj), ttpch.q4_core(tt, device="cpu"))
    for core in ("q3_core", "q10_core"):
        js, ts = getattr(jtpch, core)(tj), getattr(ttpch, core)(tt,
                                                                 device="cpu")
        assert len(js) == len(ts) == 2
        for a, b in zip(js, ts):
            _same_relations(a, b)


def test_flow_tables_match_jax():
    _same_relations(jflows.flow_tables(1 << 9, 0.05, seed=2),
                    tflows.flow_tables(1 << 9, 0.05, seed=2, device="cpu"))


def test_ratings_tables_match_jax():
    _same_relations(jnetflix.ratings_tables(1 << 12, 1 << 10, seed=6),
                    tnetflix.ratings_tables(1 << 12, 1 << 10, seed=6,
                                            device="cpu"))


def test_exact_approx_join_over_tpch_matches_jax():
    """§5.5's SUM(o_totalprice + c_acctbal) over CUSTOMER |><| ORDERS, exact
    on both sides: counts equal, the SUM within rtol 1e-5, and equal to the
    port's own repartition join."""
    t = jtpch.generate(0.002, seed=4)
    rj = jtpch.q_customer_orders(t)
    rt = ttpch.q_customer_orders(ttpch.generate(0.002, seed=4), device="cpu")
    a = jjoin.approx_join(rj, JBudget(), seed=1)
    b = tjoin.approx_join(rt, QueryBudget(), seed=1)
    assert not bool(b.diagnostics.sampled)
    assert float(b.count) == float(a.count) > 0
    np.testing.assert_allclose(float(b.estimate), float(a.estimate),
                               rtol=1e-5)
    truth = tb.repartition_join(rt)
    assert float(truth.count) == float(b.count)
    np.testing.assert_allclose(float(truth.estimate), float(b.estimate),
                               rtol=1e-5)
