"""The port's JoinServer on the CPU: every served slot equal bit for bit to
the port's own ``approx_join`` on the same (bucketed) relations and seed, on
the plain route and on the kernel route (whose wrappers take the kernels'
plain versions for CPU tensors); the stage and filter-word caches, sigma
pipelining, the latency rings, the memory rule that sizes a kernel class's
batch, and the launcher.  Against the JAX package, the served results agree
with ``repro.core.join.approx_join`` under the port's contract: integers
equal, estimates within rtol 1e-4."""

import sys

import numpy as np
import pytest
import torch

import repro.core.relation  # noqa: F401  (repro.core re-exports a function so named)
from repro.core import join as jjoin
from repro.core.budget import QueryBudget as JBudget
from repro_torch.core import bloom
from repro_torch.core.budget import QueryBudget
from repro_torch.core.cost import CostModel, SigmaRegistry
from repro_torch.core.join import approx_join, decide_sample_sizes
from repro_torch.core.relation import (bucket_capacity, bucket_to_pow2,
                                       relation, sort_by_key)
from repro_torch.core.sampling import sample_edges
from repro_torch.runtime import join_serve
from repro_torch.runtime.join_serve import (JoinRequest, JoinServer,
                                            ServerDiagnostics, ShapeClass,
                                            shape_class_of, slot_bytes)
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

jrel = sys.modules["repro.core.relation"]

MS, BM = 1024, 512   # max_strata / b_max used throughout
ROUTES = pytest.mark.parametrize("use_kernels", [False, True],
                                 ids=["plain", "kernel"])


def make_pair(rng, n=1 << 12, keys1=(0, 500), keys2=(400, 900),
              mu1=10.0, mu2=5.0):
    """Two overlapping CPU relations (keys 400..499 shared)."""
    r1 = relation(rng.integers(*keys1, n).astype(np.uint32),
                  rng.normal(mu1, 2, n).astype(np.float32), device="cpu")
    r2 = relation(rng.integers(*keys2, n).astype(np.uint32),
                  rng.normal(mu2, 1, n).astype(np.float32), device="cpu")
    return r1, r2


def _identical(a, b):
    """Bitwise equality of the user-facing result surface."""
    return all(float(getattr(a, f)) == float(getattr(b, f))
               for f in ("estimate", "error_bound", "count", "dof"))


def _req(rels, budget, qid, seed, use_kernels=False, **kw):
    return JoinRequest(rels=rels, budget=budget, query_id=qid, seed=seed,
                       max_strata=MS, b_max=BM, use_kernels=use_kernels, **kw)


def _direct(rels, budget, seed, use_kernels=False, **kw):
    return approx_join(list(rels), budget, max_strata=MS, b_max=BM,
                       seed=seed, use_kernels=use_kernels, **kw)


@ROUTES
def test_single_query_bit_identical_to_direct(rng, use_kernels):
    r1, r2 = make_pair(rng)                  # pow2: bucketing is a no-op
    srv = JoinServer(batch_slots=4)
    q = srv.submit(_req([r1, r2], QueryBudget(error=0.5), "t0", 5,
                        use_kernels))
    srv.run()
    direct = _direct([r1, r2], QueryBudget(error=0.5), 5, use_kernels)
    assert q.done and _identical(q.result, direct)
    assert bool(q.result.diagnostics.sampled)
    # live/total counts and the strata survive the batched path bit-exactly
    assert torch.equal(q.result.diagnostics.live_counts,
                       direct.diagnostics.live_counts)
    assert torch.equal(q.result.strata.keys, direct.strata.keys)
    for f in ("n_sampled", "sum_f", "sum_f2"):
        assert torch.equal(getattr(q.result.stats, f),
                           getattr(direct.stats, f)), f
    assert srv.diagnostics.kernel_queries == int(use_kernels)


@ROUTES
def test_batched_mixed_budgets_bit_identical(rng, use_kernels):
    """One engine step serves a mixed exact/sampled batch of three (padded
    to four slots); every slot is bit-identical to its own direct call."""
    pairs = [make_pair(rng),
             make_pair(rng, keys2=(450, 950)),
             make_pair(rng, mu1=3.0)]
    budgets = [QueryBudget(error=0.5), QueryBudget(error=0.5), QueryBudget()]
    srv = JoinServer(batch_slots=4)
    qs = [srv.submit(_req(list(p), b, f"t{i}", 10 + i, use_kernels))
          for i, (p, b) in enumerate(zip(pairs, budgets))]
    assert srv.step() == 3                   # one batch, same shape class
    for i, (p, b) in enumerate(zip(pairs, budgets)):
        assert _identical(qs[i].result, _direct(p, b, 10 + i, use_kernels)), i
    assert not bool(qs[2].result.diagnostics.sampled)  # exact budget
    assert srv.diagnostics.exact_queries == 1
    assert srv.diagnostics.sampled_queries == 2


def test_cache_hits_increase_on_repeat_shape_class(rng):
    r1, r2 = make_pair(rng, n=1 << 11)
    srv = JoinServer(batch_slots=2)
    srv.submit(_req([r1, r2], QueryBudget(error=0.5), "a", 1))
    srv.run()
    first = srv.diagnostics.snapshot()
    # 3 stage callables built (filter build, prepare, sample); the only hit
    # so far is the second relation reusing the build callable
    assert first["compiles"] == 3 and first["cache_hits"] == 1
    srv.submit(_req([r1, r2], QueryBudget(error=0.5), "a", 2))
    srv.run()
    second = srv.diagnostics.snapshot()
    assert second["compiles"] == first["compiles"]     # zero rebuilds
    assert second["cache_hits"] > first["cache_hits"]
    # a new shape class builds fresh stage callables
    r3, r4 = make_pair(rng, n=1 << 12)
    srv.submit(_req([r3, r4], QueryBudget(error=0.5), "a", 3))
    srv.run()
    assert srv.diagnostics.compiles > second["compiles"]


def test_interleaved_tenants_do_not_cross_contaminate_sigma(rng):
    """Tenant A and B interleave in the queue; each query_id's sigma table
    matches the one a dedicated per-tenant driver would have produced."""
    ra = make_pair(rng)
    rb = make_pair(rng, keys2=(300, 800), mu1=20.0)
    srv = JoinServer(batch_slots=2)
    for q in range(2):
        srv.submit(_req(list(ra), QueryBudget(error=0.5), "tenantA", q))
        srv.submit(_req(list(rb), QueryBudget(error=0.5), "tenantB", q))
    srv.run()
    assert set(srv.sigma.table) == {"tenantA", "tenantB"}
    for qid, rels in (("tenantA", ra), ("tenantB", rb)):
        reg = SigmaRegistry()
        for q in range(2):
            _direct(rels, QueryBudget(error=0.5), q, sigma_registry=reg,
                    query_id=qid)
        assert srv.sigma.table[qid] == reg.table[qid], qid


@ROUTES
def test_two_shape_classes_concurrently(rng, use_kernels):
    """Queries from two capacity shape classes interleave; the engine groups
    them into per-class batches and each result stays bit-identical."""
    small = make_pair(rng, n=1 << 11)
    large = make_pair(rng, n=1 << 12)
    srv = JoinServer(batch_slots=4)
    qs = []
    for q in range(2):
        for name, rels in (("s", small), ("l", large)):
            qs.append((rels, srv.submit(_req(
                list(rels), QueryBudget(error=0.5), f"{name}{q}", q,
                use_kernels))))
    srv.run()
    assert len({shape_class_of(r) for _, r in qs}) == 2
    for rels, req in qs:
        assert _identical(req.result, _direct(rels, QueryBudget(error=0.5),
                                              req.seed, use_kernels))
    assert srv.diagnostics.steps == 2        # batched, not one step/query


@ROUTES
def test_nonpow2_input_bucketed_like_direct_padded_call(rng, use_kernels):
    """Non-pow2 capacities are padded to their bucket; the result equals a
    direct approx_join on the explicitly bucketed relations."""
    n = 3000                                  # buckets to 4096
    r1, r2 = make_pair(rng, n=n)
    assert bucket_capacity(n) == 4096
    srv = JoinServer(batch_slots=2)
    q = srv.submit(_req([r1, r2], QueryBudget(error=0.5), "t", 3,
                        use_kernels))
    srv.run()
    assert q.rels[0].capacity == 4096
    direct = _direct([bucket_to_pow2(r1), bucket_to_pow2(r2)],
                     QueryBudget(error=0.5), 3, use_kernels)
    assert _identical(q.result, direct)


def test_dataset_handles_and_validation(rng):
    r1, r2 = make_pair(rng, n=1 << 11)
    srv = JoinServer(batch_slots=2)
    srv.register_dataset("shared", [r1, r2])
    q = srv.submit(JoinRequest(dataset="shared", budget=QueryBudget(),
                               query_id="t", max_strata=MS, b_max=BM))
    srv.run()
    assert _identical(q.result, _direct([r1, r2], QueryBudget(), 0))
    assert q.queue_latency_s > 0
    for bad in (JoinRequest(budget=QueryBudget()),          # no rels
                JoinRequest(dataset="nope"),                # unknown dataset
                JoinRequest(rels=[r1]),                     # one input
                JoinRequest(rels=[r1, r2], agg="median"),   # unknown agg
                JoinRequest(rels=[r1, r2], expr="max"),     # unknown expr
                JoinRequest(rels=[r1, r2], b_max=None)):    # adaptive grid
        with pytest.raises(ValueError):
            srv.submit(bad)
    assert not srv.queue


@ROUTES
def test_dataset_filter_words_built_once(rng, use_kernels):
    """N steps over a registered dataset build its filter words once per
    (num_blocks, seed); re-registering identical relations under a new
    name reuses the cache; a new seed builds fresh words."""
    r1, r2 = make_pair(rng, n=1 << 11)
    srv = JoinServer(batch_slots=1)        # force one step per query
    srv.register_dataset("ds", [r1, r2])

    def submit(name, qid, seed):
        return srv.submit(JoinRequest(dataset=name,
                                      budget=QueryBudget(error=0.5),
                                      query_id=qid, seed=seed, max_strata=MS,
                                      b_max=BM, use_kernels=use_kernels))

    q = submit("ds", "t0", 7)
    for i in range(1, 3):
        submit("ds", f"t{i}", 7)
    srv.run()
    d = srv.diagnostics
    assert d.steps == 3
    assert d.filter_builds == 2            # one per relation, built once
    assert d.filter_cache_hits == 4        # 2 later steps x 2 relations
    assert _identical(q.result, _direct([r1, r2], QueryBudget(error=0.5), 7,
                                        use_kernels))
    srv.register_dataset("ds-again", [r1, r2])
    submit("ds-again", "t3", 7)
    srv.run()
    assert srv.diagnostics.filter_builds == 2
    assert srv.diagnostics.filter_cache_hits == 6
    submit("ds", "t4", 8)                   # the filter hash is seeded
    srv.run()
    assert srv.diagnostics.filter_builds == 4


@ROUTES
def test_sigma_pipeline_matches_sequential_driver(rng, use_kernels):
    """Same-query_id error-budget repeats submitted together are deferred
    one step each, so every repeat sees the previous execution's measured
    sigma — bit-identical to a sequential driver threading feedback through
    one registry."""
    r1, r2 = make_pair(rng)
    srv = JoinServer(batch_slots=4)
    qs = [srv.submit(_req([r1, r2], QueryBudget(error=0.5), "tenant", s,
                          use_kernels)) for s in range(3)]
    srv.run()
    assert srv.diagnostics.steps == 3           # one repeat per step
    assert srv.diagnostics.sigma_deferrals == 3
    reg = SigmaRegistry()
    for s in range(3):
        direct = _direct([r1, r2], QueryBudget(error=0.5), s, use_kernels,
                         sigma_registry=reg, query_id="tenant")
        assert _identical(qs[s].result, direct), s
    assert srv.sigma.table == reg.table


def test_sigma_pipeline_fills_slots_with_other_tenants(rng):
    """Deferred repeats cost no throughput when the queue has id diversity:
    N rounds of two tenants take exactly N steps."""
    r1, r2 = make_pair(rng)
    srv = JoinServer(batch_slots=2)
    for q in range(3):
        srv.submit(_req([r1, r2], QueryBudget(error=0.5), "A", q))
        srv.submit(_req([r1, r2], QueryBudget(error=0.5), "B", q))
    srv.run()
    assert srv.diagnostics.steps == 3
    assert srv.diagnostics.max_batch == 2
    # opting out restores co-batching: all three same-id repeats in one step
    srv2 = JoinServer(batch_slots=4, sigma_pipeline=False)
    for q in range(3):
        srv2.submit(_req([r1, r2], QueryBudget(error=0.5), "A", q))
    srv2.run()
    assert srv2.diagnostics.steps == 1
    assert srv2.diagnostics.sigma_deferrals == 0


def test_backlog_serves_latency_budgets_first(rng):
    """Past backlog_slots the scheduler goes deadline-aware: the class of
    the tightest deadline is served first (counted as a promotion)."""
    small, large = make_pair(rng, n=1 << 11), make_pair(rng)
    srv = JoinServer(batch_slots=1, backlog_slots=1,
                     cost_model=CostModel(beta_compute=1e-7, epsilon=1e-3))
    first = srv.submit(_req(list(large), QueryBudget(error=0.5), "e", 0))
    urgent = srv.submit(_req(list(small), QueryBudget(latency_s=60.0), "l",
                             0))
    srv.step()
    assert urgent.done and not first.done
    assert srv.diagnostics.deadline_promotions == 1
    srv.run()
    assert first.done


def test_queue_latency_percentiles(rng):
    r1, r2 = make_pair(rng, n=1 << 11)
    srv = JoinServer(batch_slots=2)
    qs = [srv.submit(_req([r1, r2], QueryBudget(error=0.5), f"t{q}", q))
          for q in range(4)]
    srv.run()
    snap = srv.diagnostics.snapshot()
    assert "queue_latencies" not in snap        # raw ring stays internal
    assert 0 < snap["queue_latency_p50_s"] <= snap["queue_latency_p95_s"] \
        <= snap["queue_latency_max_s"]
    assert snap["queue_latency_max_s"] == \
        pytest.approx(max(q.queue_latency_s for q in qs))


def test_latency_percentiles_empty_and_single_sample():
    d = ServerDiagnostics()
    snap = d.snapshot()                        # empty rings -> hard zeros
    for k in ("queue_latency_p50_s", "queue_latency_p95_s",
              "queue_latency_max_s", "e2e_latency_p50_s",
              "e2e_latency_p95_s", "e2e_latency_max_s"):
        assert snap[k] == 0.0
    assert snap["per_tenant"] == {}
    d.note_latency("a", 0.25, 0.5, 8)          # one sample: p50 == p95 == max
    snap = d.snapshot()
    assert snap["queue_latency_p50_s"] == snap["queue_latency_p95_s"] \
        == snap["queue_latency_max_s"] == 0.25
    assert snap["e2e_latency_p95_s"] == 0.5
    assert snap["per_tenant"]["a"]["samples"] == 1
    assert snap["per_tenant"]["a"]["queue_latency_p95_s"] == 0.25


def test_latency_percentiles_ring_wrap_and_reset():
    """With cap=4, eight samples 0..7 leave exactly the last four, and the
    percentiles describe those — while the cumulative sums cover all."""
    d = ServerDiagnostics()
    for i in range(8):
        d.note_latency("t", float(i), float(i), 4)
    assert d.queue_latencies == [4.0, 5.0, 6.0, 7.0]
    assert d.tenant_latencies["t"][0] == [4.0, 5.0, 6.0, 7.0]
    snap = d.snapshot()
    assert snap["queue_latency_max_s"] == 7.0
    assert snap["queue_latency_p50_s"] == pytest.approx(5.5)
    assert snap["queue_latency_p95_s"] == pytest.approx(6.85)
    assert d.queue_latency_s == sum(range(8))
    d.reset_latencies()
    assert d.queue_latencies == [] and d.e2e_latencies == []
    assert d.tenant_latencies == {}
    assert d.queue_latency_s == sum(range(8))  # sums survive a ring reset
    assert d.snapshot()["queue_latency_p95_s"] == 0.0


def test_latency_ring_bounded_by_server_cap(rng):
    r1, r2 = make_pair(rng, n=1 << 11)
    srv = JoinServer(batch_slots=2, latency_samples=2)
    for q in range(5):
        srv.submit(_req([r1, r2], QueryBudget(error=0.5), "t/a", q))
        srv.run()
    d = srv.diagnostics
    assert d.queries == 5
    assert len(d.queue_latencies) == 2 and len(d.e2e_latencies) == 2
    assert len(d.tenant_latencies["t"][0]) == 2
    assert d.snapshot()["per_tenant"]["t"]["samples"] == 2


def test_kernel_batch_mixed_seeds_bit_identical_to_per_query(rng):
    """ONE engine step serves a mixed-seed kernel batch (a seed of
    0xFFFFFFFF among them, whose sampling seed wraps to 0), and every slot
    is bit-identical to its own approx_join(use_kernels=True) call."""
    r1, r2 = make_pair(rng, n=1 << 11)
    srv = JoinServer(batch_slots=4)
    seeds = [3, 0xFFFFFFFF, 3, 250]
    qs = [srv.submit(JoinRequest(rels=[r1, r2], budget=QueryBudget(error=0.5),
                                 query_id=f"t{i}", seed=s, max_strata=512,
                                 b_max=256, use_kernels=True))
          for i, s in enumerate(seeds)]
    assert srv.step() == 4                    # one batch, no per-query loop
    for i, s in enumerate(seeds):
        direct = approx_join([r1, r2], QueryBudget(error=0.5), max_strata=512,
                             b_max=256, seed=s, use_kernels=True)
        assert _identical(qs[i].result, direct), (i, s)
        assert bool(qs[i].result.diagnostics.sampled)
    assert srv.diagnostics.kernel_queries == 4
    assert srv.diagnostics.max_batch == 4
    assert srv.diagnostics.kernel_gather_bytes == 0.0


@ROUTES
def test_seed_0xffffffff_wraps_to_sampler_seed_0(rng, use_kernels):
    """The sampler's seed is (seed + 1) mod 2^32: a request of seed
    0xFFFFFFFF hashes its filters under 0xFFFFFFFF and draws under 0, as
    approx_join does."""
    r1, r2 = make_pair(rng, n=1 << 11)
    srv = JoinServer(batch_slots=2)
    q = srv.submit(_req([r1, r2], QueryBudget(error=0.5), "w", 0xFFFFFFFF,
                        use_kernels))
    srv.run()
    assert _identical(q.result, _direct([r1, r2], QueryBudget(error=0.5),
                                        0xFFFFFFFF, use_kernels))
    st = q.result.strata
    nb = bloom.num_blocks_for(1 << 11, 0.01)
    jf = bloom.intersect_all([bloom.build(r.keys, r.valid, nb, 0xFFFFFFFF)
                              for r in (r1, r2)])
    live = [sort_by_key(r._replace(valid=r.valid & bloom.contains(jf, r.keys)))
            for r in (r1, r2)]
    b_i = decide_sample_sizes(QueryBudget(error=0.5), st, None, 0.0, None,
                              0.95)
    for seed, same in ((0, True), (1, False)):
        stats = sample_edges(live, st, b_i, BM, seed).stats
        assert torch.equal(stats.n_sampled, q.result.stats.n_sampled)
        assert torch.equal(stats.sum_f, q.result.stats.sum_f) == same, seed


def test_kernel_seed_sweep_no_rebuilds(rng):
    """A 16-seed warm sweep over one kernel shape class (mixed batch fills
    too) keeps the stage-build AND filter-build counters flat — seeds are
    runtime operands and the dataset words cache ignores the sampling
    seed when filter_seed is fixed."""
    r1, r2 = make_pair(rng, n=1 << 11)
    srv = JoinServer(batch_slots=4)
    srv.register_dataset("ds", [r1, r2])

    def submit(q, seed):
        return srv.submit(JoinRequest(
            dataset="ds", budget=QueryBudget(error=0.5), query_id=f"t{q}",
            seed=seed, filter_seed=7, max_strata=512, b_max=256,
            use_kernels=True))

    for q in range(4):                         # warm the 4- and 2-wide fills
        submit(q, seed=1000 + q)
    srv.run()
    for q in range(2):
        submit(q, seed=2000 + q)
    srv.run()
    warm = srv.diagnostics.snapshot()
    assert warm["filter_builds"] == 2          # one per relation, ever
    qs = []
    for seed in range(16):
        qs.append(submit(seed % 4, seed))
        if seed % 4 == 3:
            srv.run()
    for seed in range(16, 20, 2):
        submit(0, seed), submit(1, seed + 1)
        srv.run()
    after = srv.diagnostics.snapshot()
    assert after["compiles"] == warm["compiles"], "seed sweep rebuilt stages"
    assert after["filter_builds"] == warm["filter_builds"]
    assert all(q.done for q in qs)


def test_slot_bytes_counts_a_slots_arrays():
    """At the smoke's large class (2 x 2^24 rows, 2^16 strata) a slot holds
    about 1.2 GiB: rows, sorted copies and argsort indices, three 32 MiB
    filters, and the strata arrays."""
    cls = ShapeClass((1 << 24, 1 << 24), 2, 1 << 16, 2048, "sum", "sum",
                     False, True, 0.01, 0.95)
    rows = 2 * (1 << 24) * (8 + 4 + 1) * 2 + 2 * (1 << 24) * 8
    filters = 3 * (1 << 20) * 32
    strata = (1 << 16) * (8 + 1 + 2 * 16 + 5 * 4)
    assert slot_bytes(cls) == rows + filters + strata
    assert 1.15 * 2**30 < slot_bytes(cls) < 1.25 * 2**30


@pytest.mark.parametrize("n_inputs,dedup", [(3, False), (2, True)])
def test_slot_bytes_counts_the_plain_samplers_grid(n_inputs, dedup):
    """A kernel class the sampler kernel does not take (n-way or dedup)
    draws with plain torch, whose [max_strata, b_max] grids a slot also
    holds: 20 n + 40 bytes a cell.  At phase 8's 3-way shape (3 x 2^24
    rows, 2^16 strata, b_max 2048) that is about 14.2 GiB a slot."""
    caps = (1 << 24,) * n_inputs
    cls = ShapeClass(caps, n_inputs, 1 << 16, 2048, "sum", "sum", dedup,
                     True, 0.01, 0.95)
    kernel = cls._replace(caps=caps[:2], n_inputs=2, dedup=False)
    assert join_serve.kernel_sampler(kernel)
    assert not join_serve.kernel_sampler(cls)
    assert not join_serve.kernel_sampler(kernel._replace(use_kernels=False))
    rows = n_inputs * (1 << 24) * (13 + 13 + 8)
    filters = (n_inputs + 1) * (1 << 20) * 32
    strata = (1 << 16) * (8 + 1 + 16 * n_inputs + 20)
    grid = (1 << 16) * 2048 * (20 * n_inputs + 40)
    assert slot_bytes(cls) == rows + filters + strata + grid
    if n_inputs == 3:
        assert 14.0 * 2**30 < slot_bytes(cls) < 14.5 * 2**30


def test_kernel_batch_width_capped_by_slot_memory(rng, monkeypatch):
    """A kernel class whose slots fit the memory budget only twice serves
    in batches of two (a pow2 floor), each slot still bit-identical to its
    per-query approx_join; the plain route keeps batch_slots."""
    r1, r2 = make_pair(rng, n=1 << 11)
    reqs = [JoinRequest(rels=[r1, r2], budget=QueryBudget(error=0.5),
                        query_id=f"t{i}", seed=10 + i, max_strata=512,
                        b_max=256, use_kernels=True) for i in range(4)]
    cls = ShapeClass((2048, 2048), 2, 512, 256, "sum", "sum", False, True,
                     0.01, 0.95)
    monkeypatch.setattr(join_serve, "HOST_SLOT_MEMORY",
                        3 * slot_bytes(cls) - 1)
    srv = JoinServer(batch_slots=4)
    qs = [srv.submit(r) for r in reqs]
    srv.run()
    assert srv.diagnostics.max_batch == 2        # capped below batch_slots
    assert srv.diagnostics.steps == 2
    for i, q in enumerate(qs):
        direct = approx_join([r1, r2], QueryBudget(error=0.5), max_strata=512,
                             b_max=256, seed=10 + i, use_kernels=True)
        assert _identical(q.result, direct), i
    monkeypatch.setattr(join_serve, "HOST_SLOT_MEMORY", 1)
    plain = JoinServer(batch_slots=4)
    for i in range(4):
        plain.submit(_req([r1, r2], QueryBudget(error=0.5), f"p{i}", i))
    plain.run()
    assert plain.diagnostics.max_batch == 4
    kern = JoinServer(batch_slots=4)             # never below one slot
    kern.submit(_req([r1, r2], QueryBudget(error=0.5), "k", 0, True))
    kern.run()
    assert kern.diagnostics.max_batch == 1


def test_kernel_route_accepts_filter_seed_and_prebuilt_words(rng):
    """filter_seed decoupling and prebuilt words work on the kernel route
    and stay bit-identical to the plain route under the same split."""
    r1, r2 = make_pair(rng, n=1 << 11)
    srv = JoinServer(batch_slots=2)

    def submit(use_kernels, **kw):
        return srv.submit(JoinRequest(
            rels=[r1, r2], budget=QueryBudget(error=0.5), seed=3,
            max_strata=512, b_max=256, use_kernels=use_kernels, **kw))

    a = submit(True, query_id="k", filter_seed=9)
    b = submit(False, query_id="j", filter_seed=9)
    srv.run()
    assert _identical(a.result, b.result)

    nb = bloom.num_blocks_for(1 << 11, 0.01)
    words = [bloom.build(r.keys, r.valid, nb, 9).words for r in (r1, r2)]
    c = submit(True, query_id="kw")
    c.filter_seed = 9
    c._words = words
    d = submit(True, query_id="kw2", filter_seed=9)
    srv.run()
    assert _identical(c.result, d.result)      # prebuilt == cache-built


# -- against the JAX package -------------------------------------------------

def _arrays(seed, n=2048):
    rng = np.random.default_rng(seed)
    out = []
    for (lo, hi), mu in (((0, 300), 10.0), ((200, 600), 5.0)):
        k = (rng.integers(lo, hi, n) * 2654435761 % 2**32).astype(np.uint32)
        out.append((k, rng.normal(mu, 2, n).astype(np.float32),
                    rng.random(n) > 0.1))
    return out


@pytest.mark.parametrize("budget", ["exact", "error"])
@ROUTES
def test_served_results_match_jax_approx_join(use_kernels, budget):
    """Slots of one served batch (mixed seeds) against the JAX package's
    approx_join on the same numpy relations: integers equal, estimates and
    error bounds within rtol 1e-4 (float32 sums run in another order)."""
    seeds = (1, 2, 40)
    arrs = [_arrays(s) for s in seeds]
    tb, jb = ((QueryBudget(), JBudget()) if budget == "exact"
              else (QueryBudget(error=0.5), JBudget(error=0.5)))
    kw = dict(max_strata=512, b_max=128, use_kernels=use_kernels)
    srv = JoinServer(batch_slots=4)
    qs = [srv.submit(JoinRequest(
        rels=[relation(*a, device="cpu") for a in arr], budget=tb,
        query_id=f"t{i}", seed=s, **kw))
        for i, (s, arr) in enumerate(zip(seeds, arrs))]
    assert srv.step() == 3
    for q, s, arr in zip(qs, seeds, arrs):
        rj = jjoin.approx_join([jrel.relation(*a) for a in arr], jb, seed=s,
                               **kw)
        rt = q.result
        np.testing.assert_allclose(float(rt.estimate),
                                   float(np.asarray(rj.estimate)), rtol=1e-4)
        np.testing.assert_allclose(float(rt.error_bound),
                                   float(np.asarray(rj.error_bound)),
                                   rtol=1e-4, atol=1e-6)
        assert float(rt.count) == float(np.asarray(rj.count))
        dj, dt = rj.diagnostics, rt.diagnostics
        assert bool(dj.sampled) == dt.sampled
        for name in ("total_counts", "live_counts", "num_strata",
                     "strata_overflow", "sample_draws"):
            np.testing.assert_array_equal(np.asarray(getattr(dj, name)),
                                          getattr(dt, name).numpy(),
                                          err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(rj.strata.keys).astype(np.int64),
            rt.strata.keys.numpy())


# -- the launcher --------------------------------------------------------------

def test_launcher_serves_on_the_cpu_and_writes_a_trace(tmp_path, capsys):
    from repro_torch.launch import join_serve as launch
    from repro_torch.launch.trace_dump import summarize
    from repro_torch.runtime.telemetry import validate_chrome_trace
    path = tmp_path / "t.json"
    out = launch.run(tenants=3, queries_per_tenant=2, slots=4, base_n=1 << 10,
                     device="cpu", trace_out=str(path))
    assert out["queries"] == 6 and out["device"] == "cpu"
    assert out["kernel_queries"] == 6 and out["max_batch"] >= 2
    assert out["exact_queries"] >= 2 and out["sampled_queries"] >= 2
    assert "[join-serve] 6 queries from 3 tenants" in capsys.readouterr().out
    import json
    obj = json.loads(path.read_text())
    assert validate_chrome_trace(obj) > 0
    text = summarize(obj)
    assert "by category:" in text and "path kernel:" in text
