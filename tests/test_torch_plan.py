"""The port's query plans on the CPU: the meshless cases of
``tests/test_plan.py`` (plan IR validation and typed errors, flattening,
multi-relation datasets, the §3.1 ``(n + 1)`` filter exchange, strata grids
sized from the largest input, n-way joins and a mixed 2-/3-way batch through
the server, the compiled-plan cache, the pushdown byte model, plans across
snapshot/restore and through the async tier), with each served plan held
bit for bit against the port's own composed direct ``approx_join`` calls on
the plain and the kernel route (whose wrappers take the kernels' plain
versions for CPU tensors).  Against the JAX package: the port's
``compile_plan`` equals ``repro.core.plan.compile_plan`` on the same
datasets (integers exact, overlap and reduction within 1e-12), and every
served plan node agrees with ``repro.core.join.approx_join`` on the node's
concatenated leaf relations (integers equal, estimates within rtol 1e-4)."""

import sys

import numpy as np
import pytest
import torch

import repro.core.relation  # noqa: F401  (repro.core re-exports a function so named)
from repro.core import join as jjoin
from repro.core import plan as jplan
from repro.core.budget import QueryBudget as JBudget
from repro_torch.core import bloom
from repro_torch.core.budget import QueryBudget
from repro_torch.core.join import (TUPLE_BYTES, approx_join,
                                   filter_exchange_bytes, prepare_stage_pre)
from repro_torch.core.plan import Plan, PlanNode, compile_plan, node_bytes_model
from repro_torch.core.relation import relation
from repro_torch.data.synthetic import overlapping_relations
from repro_torch.runtime.join_serve import JoinRequest, JoinServer
from repro_torch.runtime.telemetry import Tracer
from torch_accuracy import (GateConfig, one_torch_thread,  # noqa: F401
                            run_accuracy_gate)

jrel = sys.modules["repro.core.relation"]

ERR = QueryBudget(error=0.05)
BM = 256   # b_max: a draw grid of [max_strata, BM] keeps the CPU runs short
ROUTES = pytest.mark.parametrize("use_kernels", [False, True],
                                 ids=["plain", "kernel"])


def _rels(n, rows=1 << 10, seed=3, overlap=0.25):
    return overlapping_relations([rows] * n, overlap, seed=seed, device="cpu")


def _jax_rel(r):
    """The JAX package's relation of the same rows."""
    return jrel.relation(r.keys.numpy().astype(np.uint32), r.values.numpy(),
                         r.valid.numpy())


def _identical(a, b) -> bool:
    """Bitwise equality of two JoinResults (scalars + strata grid)."""
    if a.strata.keys.shape != b.strata.keys.shape:
        return False
    return all(float(getattr(a, f)) == float(getattr(b, f))
               for f in ("estimate", "error_bound", "count", "dof")) \
        and torch.equal(a.strata.keys, b.strata.keys)


# -- plan IR ----------------------------------------------------------------

def test_plan_validation():
    with pytest.raises(ValueError, match="at least one node"):
        Plan(())
    with pytest.raises(ValueError, match="duplicate"):
        Plan((PlanNode("x", ("a", "b")), PlanNode("x", ("a", "b"))))
    with pytest.raises(ValueError, match="references itself"):
        Plan((PlanNode("x", ("x", "a")),))
    with pytest.raises(ValueError, match="no inputs"):
        PlanNode("x", ())
    with pytest.raises(ValueError, match="reserved"):
        PlanNode("a/b", ("a", "b"))


def test_compile_rejects_unknown_and_degenerate():
    a, b = _rels(2)
    datasets = {"a": [a], "b": [b]}
    with pytest.raises(ValueError, match="neither an earlier plan node"):
        compile_plan(Plan((PlanNode("x", ("a", "nope")),)), datasets)
    # forward references read as (unknown) dataset names: order = topo order
    with pytest.raises(ValueError, match="neither an earlier plan node"):
        compile_plan(Plan((PlanNode("x", ("a", "y")),
                           PlanNode("y", ("a", "b")))), datasets)
    with pytest.raises(ValueError, match="at least two"):
        compile_plan(Plan((PlanNode("x", ("a",)),)), datasets)


def test_plan_flattening_fuses_leaf_sets():
    plan = Plan((PlanNode("ab", ("a", "b")),
                 PlanNode("abc", ("ab", "c")),
                 PlanNode("deep", ("abc", "ab", "d"))))
    assert plan.leaf_inputs("ab") == ("a", "b")
    assert plan.leaf_inputs("abc") == ("a", "b", "c")
    # recursive expansion, order-preserving dedupe
    assert plan.leaf_inputs("deep") == ("a", "b", "c", "d")
    assert plan.hierarchy() == {"ab": [], "abc": ["ab"],
                                "deep": ["abc", "ab"]}
    with pytest.raises(ValueError, match="unknown plan node"):
        plan.leaf_inputs("zz")


def test_compile_expands_multi_relation_datasets():
    a, b, c = _rels(3)
    compiled = compile_plan(Plan((PlanNode("j", ("pair", "c")),)),
                            {"pair": [a, b], "c": [c]})
    assert compiled.nodes[0].n_rels == 3
    assert compiled.bytes_model["j"]["n"] == 3


# -- bloom intersect validation ---------------------------------------------

def test_intersect_all_typed_validation():
    r1, r2 = _rels(2, rows=256)
    f1 = bloom.build(r1.keys, r1.valid, 8, seed=0)
    f2 = bloom.build(r2.keys, r2.valid, 8, seed=0)
    with pytest.raises(ValueError, match="at least one filter"):
        bloom.intersect_all([])
    with pytest.raises(ValueError, match="num_blocks mismatch"):
        bloom.intersect_all([f1, bloom.build(r2.keys, r2.valid, 16, seed=0)])
    with pytest.raises(ValueError, match="seed"):
        bloom.intersect_all([f1, bloom.build(r2.keys, r2.valid, 8, seed=9)])
    merged = bloom.intersect_all([f1, f2])
    assert torch.equal(merged.words, f1.words & f2.words)
    assert bloom.intersect_all([f1]) is not None


def test_prepare_pre_asserts_shape_agreement():
    rels = _rels(3, rows=256)
    nb = bloom.num_blocks_for(256, 0.01)
    words = torch.stack([bloom.build(r.keys, r.valid, nb, 0).words
                         for r in rels[:2]])
    with pytest.raises(ValueError, match="2 prebuilt filters for 3 inputs"):
        prepare_stage_pre(rels, words, 256, 0)


# -- §3.1 filter-exchange formula -------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4])
def test_filter_exchange_bytes_nway(n):
    """Diagnostics must charge live tuples + the (n + 1) filter transfers of
    §3.1 (n per-dataset filters to the merge site + one broadcast back)."""
    res = approx_join(_rels(n, rows=512), ERR, seed=2, b_max=BM)
    d = res.diagnostics
    expect = int(d.live_counts.sum()) * TUPLE_BYTES \
        + d.filter_bytes * (n + 1)
    assert int(d.shuffled_bytes_filtered) == expect
    assert int(filter_exchange_bytes(n, d.filter_bytes)) \
        == d.filter_bytes * (n + 1)


# -- strata-grid sizing regression (rels[0] -> max) -------------------------

def _asymmetric():
    rng = np.random.default_rng(0)
    small = relation(np.arange(512, dtype=np.uint32),
                     rng.poisson(10, 512).astype(np.float32), device="cpu")
    big = relation(rng.integers(0, 3000, 4096).astype(np.uint32),
                   rng.poisson(10, 4096).astype(np.float32), device="cpu")
    return small, big


def test_strata_grid_sized_from_largest_input_driver():
    """The default strata grid must equal sizing from the LARGEST input."""
    small, big = _asymmetric()
    default = approx_join([small, big], ERR, seed=1, b_max=BM)
    explicit = approx_join([small, big], ERR, seed=1, max_strata=4096,
                           b_max=BM)
    assert default.strata.keys.shape == explicit.strata.keys.shape
    assert _identical(default, explicit)
    assert int(default.diagnostics.strata_overflow) == 0


def test_strata_grid_sized_from_largest_input_server():
    """A default-sized request resolves ``max_strata`` to the largest
    input's (bucketed) capacity and serves bit-identically to the
    explicitly max-sized driver call."""
    small, big = _asymmetric()
    srv = JoinServer(batch_slots=2)
    req = srv.submit(JoinRequest(rels=[small, big], budget=ERR, seed=1,
                                 b_max=BM))
    srv.run()
    assert req.max_strata == 4096
    explicit = approx_join([small, big], ERR, seed=1, max_strata=4096,
                           b_max=BM)
    assert _identical(req.result, explicit)


# -- n-way joins through the server -----------------------------------------

@pytest.mark.parametrize("n", [3, 4])
def test_nway_served_bit_identical(n):
    rels = _rels(n)
    srv = JoinServer(batch_slots=4)
    req = srv.submit(JoinRequest(rels=rels, budget=ERR, seed=5,
                                 query_id=f"q{n}", b_max=BM))
    srv.run()
    direct = approx_join(rels, ERR, seed=5, query_id=f"q{n}",
                         max_strata=req.max_strata, b_max=BM)
    assert _identical(req.result, direct)


@ROUTES
def test_mixed_two_and_three_way_batch(use_kernels):
    """2-way and 3-way queries submitted together serve in separate shape
    classes (one step each), each bit-identical to its direct call."""
    rels3 = _rels(3)
    srv = JoinServer(batch_slots=4)
    reqs2 = [srv.submit(JoinRequest(rels=rels3[:2], budget=ERR, seed=s,
                                    query_id=f"two{s}", b_max=BM,
                                    use_kernels=use_kernels))
             for s in (1, 2)]
    reqs3 = [srv.submit(JoinRequest(rels=rels3, budget=ERR, seed=s,
                                    query_id=f"three{s}", b_max=BM,
                                    use_kernels=use_kernels))
             for s in (1, 2)]
    assert reqs2[0]._class != reqs3[0]._class
    srv.run()
    assert srv.diagnostics.steps == 2
    for req, n in [(r, 2) for r in reqs2] + [(r, 3) for r in reqs3]:
        direct = approx_join(rels3[:n], ERR, seed=req.seed,
                             query_id=req.query_id,
                             max_strata=req.max_strata, b_max=BM,
                             use_kernels=use_kernels)
        assert _identical(req.result, direct), req.query_id


def test_three_way_kernel_width_capped_by_its_sampler_grid(monkeypatch):
    """A 3-way kernel class's slots hold the plain sampler's grids: with
    memory for three slots of it, four requests serve two a step, each
    bit-identical to its direct call."""
    from repro_torch.runtime import join_serve
    rels = _rels(3)
    reqs = [JoinRequest(rels=rels, budget=ERR, seed=s, query_id=f"w{s}",
                        b_max=BM, use_kernels=True) for s in range(4)]
    srv = JoinServer(batch_slots=4)
    cls = srv.submit(reqs[0])._class
    monkeypatch.setattr(join_serve, "HOST_SLOT_MEMORY",
                        3 * join_serve.slot_bytes(cls) - 1)
    for r in reqs[1:]:
        srv.submit(r)
    srv.run()
    assert srv.diagnostics.max_batch == 2 and srv.diagnostics.steps == 2
    for r in reqs:
        direct = approx_join(rels, ERR, seed=r.seed, query_id=r.query_id,
                             max_strata=r.max_strata, b_max=BM,
                             use_kernels=True)
        assert _identical(r.result, direct), r.query_id


# -- plans through the engine -----------------------------------------------

def _abc_server(**kw):
    srv = JoinServer(batch_slots=4, **kw)
    for name, r in zip("abcd", _rels(4)):
        srv.register_dataset(name, [r])
    return srv


def _plan(use_kernels=False):
    return Plan((PlanNode("ab", ("a", "b"), budget=ERR, b_max=BM,
                          use_kernels=use_kernels),
                 PlanNode("abc", ("ab", "c"), budget=ERR, b_max=BM,
                          use_kernels=use_kernels)))


LEAVES = (("ab", ("a", "b")), ("abc", ("a", "b", "c")))


def _assert_plan_parity(srv, results, seed, query_id="p0",
                        use_kernels=False):
    """Every node bit-identical to the port's composed direct call over its
    flattened leaf relations (same seed, same query id)."""
    for name, leaves in LEAVES:
        direct_rels = [r for d in leaves for r in srv.datasets[d]]
        direct = approx_join(direct_rels, ERR, seed=seed,
                             query_id=f"{query_id}/{name}",
                             max_strata=max(r.capacity for r in direct_rels),
                             b_max=BM, use_kernels=use_kernels)
        assert _identical(results[name], direct), name


@ROUTES
def test_plan_served_bit_identical_to_composed_calls(use_kernels):
    srv = _abc_server()
    handle = srv.submit_plan(_plan(use_kernels), query_id="p0", seed=7)
    assert set(handle.requests) == {"ab", "abc"}
    assert "p0" in srv.plans and not handle.done
    srv.run()
    assert handle.done
    assert "p0" not in srv.plans        # completed handles are dropped
    assert srv.diagnostics.kernel_queries == 2 * int(use_kernels)
    _assert_plan_parity(srv, handle.results(), seed=7,
                        use_kernels=use_kernels)


def test_plan_route_override_at_submit():
    """``submit_plan(use_kernels=...)`` overrides every node's route."""
    srv = _abc_server()
    handle = srv.submit_plan(_plan(False), query_id="p0", seed=7,
                             use_kernels=True)
    srv.run()
    assert all(r.use_kernels for r in handle.requests.values())
    _assert_plan_parity(srv, handle.results(), seed=7, use_kernels=True)


def test_plan_cache_and_zero_recompiles():
    srv = _abc_server()
    h1 = srv.submit_plan(_plan(), query_id="p1", seed=1)
    srv.run()
    assert srv.diagnostics.plan_compiles == 1
    compiles = srv.diagnostics.compiles
    h2 = srv.submit_plan(_plan(), query_id="p2", seed=2)
    srv.run()
    assert srv.diagnostics.plan_cache_hits == 1
    assert srv.diagnostics.plan_compiles == 1
    assert srv.diagnostics.compiles == compiles   # warm stages reused
    assert h1.results().keys() == h2.results().keys()


def test_plan_pushdown_model_beats_binary_tree():
    """Fusing to one n-way stage with the full cascaded intersection pushed
    down must beat the left-deep binary tree."""
    compiled = _abc_server().compile_plan(_plan())
    m2, m3 = compiled.bytes_model["ab"], compiled.bytes_model["abc"]
    assert m2["reduction_x"] == 1.0               # 2-way: same plan either way
    assert m3["bytes_pushdown"] < m3["bytes_binary"]
    assert m3["reduction_x"] > 1.0
    assert 0.0 < m3["overlap"] <= 1.0


def test_node_bytes_model_two_way_equal():
    """n = 2 sanity: pushdown and binary models coincide exactly."""
    m = node_bytes_model(_rels(2, rows=512))
    assert m["bytes_pushdown"] == m["bytes_binary"]
    assert m["reduction_x"] == 1.0


def test_plan_trace_hierarchy_and_byte_pairs():
    """The ``plan`` instant carries the node hierarchy, node spans carry
    their plan, and each node's reconciliation record pairs the compiled
    ``bytes_pushdown`` with the served live bytes plus the exchange."""
    srv = _abc_server(tracer=Tracer(enabled=True))
    handle = srv.submit_plan(_plan(), query_id="pt", seed=3)
    srv.run()
    inst = [e for e in srv.tracer.events if e["name"] == "plan"]
    assert len(inst) == 1
    assert inst[0]["args"]["hierarchy"] == {"ab": [], "abc": ["ab"]}
    assert any(e["name"] == "plan-compile" for e in srv.tracer.events)
    spans = [e for e in srv.tracer.events if e["name"] == "query"]
    assert {(e["args"]["plan"], e["args"]["plan_node"]) for e in spans} \
        == {("pt", "ab"), ("pt", "abc")}
    model = srv.compile_plan(_plan()).bytes_model
    recs = {r["plan_node"]: r for r in srv.tracer.recon}
    for name, req in handle.requests.items():
        pair = next(p for p in recs[name]["pairs"]
                    if p["name"] == "node_bytes_model")
        d = req.result.diagnostics
        assert pair["modeled"] == float(model[name]["bytes_pushdown"])
        assert pair["measured"] == float(d.shuffled_bytes_filtered)


def test_plan_survives_snapshot_restore():
    """A failover never drops an in-flight plan: snapshot with the plan
    queued, restore into a fresh engine, serve there: handle regrouped,
    results bit-identical to the original engine's."""
    src = _abc_server()
    h_src = src.submit_plan(_plan(), query_id="pf", seed=9)
    flat, meta = src.snapshot_state()

    dst = JoinServer(batch_slots=4)
    restored = dst.restore_state(flat, meta, device="cpu")
    assert len(restored) == 2
    assert "pf" in dst.plans
    h_dst = dst.plans["pf"]
    assert set(h_dst.requests) == {"ab", "abc"}
    dst.run()
    assert h_dst.done and "pf" not in dst.plans
    src.run()
    for name in ("ab", "abc"):
        assert _identical(h_dst.results()[name], h_src.results()[name]), name
    _assert_plan_parity(dst, h_dst.results(), seed=9, query_id="pf")


def test_plan_async_served_bit_identical():
    from repro_torch.runtime.async_serve import AsyncJoinServer
    inner = _abc_server()
    with AsyncJoinServer(inner) as asrv:
        futs = asrv.submit_plan(_plan(), query_id="ap", seed=11)
        results = {name: f.result(timeout=120).result
                   for name, f in futs.items()}
    _assert_plan_parity(inner, results, seed=11, query_id="ap")


def test_plan_front_door_routes_plan_whole():
    from repro_torch.runtime.async_serve import AsyncJoinFrontDoor
    rels = _rels(3)
    with AsyncJoinFrontDoor(replicas=2, device="cpu") as door:
        for name, r in zip("abc", rels):
            door.register_dataset(name, [r])
        futs = door.submit_plan(_plan(), query_id="fd", seed=4)
        served = {name: f.result(timeout=120) for name, f in futs.items()}
        # one tenant -> one replica: the whole plan landed on one engine
        owners = [rep for rep in door.replicas
                  if rep.engine.diagnostics.queries > 0]
        assert len(owners) == 1
    assert all(r.done and r.result is not None for r in served.values())
    direct = approx_join(list(rels), ERR, seed=4, query_id="fd/abc",
                         max_strata=max(r.capacity for r in rels), b_max=BM)
    assert _identical(served["abc"].result, direct)


# -- statistical accuracy gate for plans ------------------------------------

PLAN_CFG = GateConfig(n_rels=3, replications=12)


def test_plan_accuracy_gate():
    """One 3-way single-node plan per replication, served end to end."""
    server = JoinServer(batch_slots=1)

    def backend(rels, seed):
        names = []
        for i, r in enumerate(rels):
            name = f"rep{seed}_{i}"
            server.register_dataset(name, [r])
            names.append(name)
        plan = Plan((PlanNode(
            "node", tuple(names),
            budget=QueryBudget(error=0.5,
                               pilot_fraction=PLAN_CFG.pilot_fraction),
            max_strata=PLAN_CFG.max_strata, b_max=PLAN_CFG.b_max),))
        handle = server.submit_plan(plan, query_id=f"rep{seed}", seed=seed)
        server.run()
        res = handle.results()["node"]
        return (float(res.estimate), float(res.error_bound),
                float(res.count), res.stats)

    rep = run_accuracy_gate(backend, PLAN_CFG)
    assert rep.passed, rep.summary()
    assert rep.checked_allocation


# -- against the JAX package -------------------------------------------------

def _datasets(n_rels=4, rows=1 << 10):
    """The same relations as port datasets and as JAX datasets, ``pair``
    holding two of them."""
    rels = _rels(n_rels, rows=rows)
    port = {name: [r] for name, r in zip("abcd", rels)}
    port["pair"] = [rels[0], rels[3]]
    return port, {k: [_jax_rel(r) for r in v] for k, v in port.items()}


@pytest.mark.parametrize("fp_rate", [0.01, 0.1])
def test_compile_plan_matches_jax(fp_rate):
    port, jax_ds = _datasets()
    nodes = lambda pn: (  # noqa: E731
        pn("ab", ("a", "b"), fp_rate=fp_rate),
        pn("abc", ("ab", "c"), fp_rate=fp_rate),
        pn("w", ("pair", "abc"), fp_rate=fp_rate))
    got = compile_plan(Plan(nodes(PlanNode)), port, model_seed=5)
    want = jplan.compile_plan(jplan.Plan(nodes(jplan.PlanNode)), jax_ds,
                              model_seed=5)
    assert [(n.datasets, n.n_rels) for n in got.nodes] \
        == [(n.datasets, n.n_rels) for n in want.nodes]
    assert got.bytes_model.keys() == want.bytes_model.keys()
    for name, m in got.bytes_model.items():
        w = want.bytes_model[name]
        for k in ("n", "filter_bytes", "live_counts", "total_count",
                  "bytes_pushdown", "bytes_binary"):
            assert m[k] == w[k], (name, k)
        for k in ("overlap", "reduction_x"):
            assert m[k] == pytest.approx(w[k], rel=1e-12), (name, k)
    assert got.bytes_model["abc"]["bytes_pushdown"] \
        < got.bytes_model["abc"]["bytes_binary"]


@ROUTES
def test_served_plan_nodes_match_jax_approx_join(use_kernels):
    """Each served node against the JAX package's approx_join on the node's
    concatenated leaf relations: integers equal, estimates and bounds
    within rtol 1e-4 (float32 sums run in another order)."""
    srv = _abc_server()
    handle = srv.submit_plan(_plan(use_kernels), query_id="pj", seed=6)
    srv.run()
    for name, leaves in LEAVES:
        rels = [r for d in leaves for r in srv.datasets[d]]
        rj = jjoin.approx_join([_jax_rel(r) for r in rels],
                               JBudget(error=0.05), seed=6,
                               query_id=f"pj/{name}",
                               max_strata=max(r.capacity for r in rels),
                               b_max=BM, use_kernels=use_kernels)
        rt = handle.results()[name]
        np.testing.assert_allclose(float(rt.estimate),
                                   float(np.asarray(rj.estimate)), rtol=1e-4)
        np.testing.assert_allclose(float(rt.error_bound),
                                   float(np.asarray(rj.error_bound)),
                                   rtol=1e-4, atol=1e-6)
        assert float(rt.count) == float(np.asarray(rj.count))
        dj, dt = rj.diagnostics, rt.diagnostics
        assert bool(dj.sampled) == dt.sampled
        for f in ("total_counts", "live_counts", "num_strata",
                  "strata_overflow", "sample_draws"):
            np.testing.assert_array_equal(np.asarray(getattr(dj, f)),
                                          getattr(dt, f).numpy(), err_msg=f)
        np.testing.assert_array_equal(
            np.asarray(rj.strata.keys).astype(np.int64),
            rt.strata.keys.numpy())
        np.testing.assert_array_equal(np.asarray(rj.stats.n_sampled),
                                      rt.stats.n_sampled.numpy())
