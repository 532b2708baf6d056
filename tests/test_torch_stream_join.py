"""The port's streaming server on the CPU: incremental window filters (the
slide contract), bit-parity with the re-register baseline, window expiry,
running estimates, per-tenant admission / shedding, and the per-window
accuracy gate (``tests/torch_accuracy.py``) — the single-device cases of
``tests/test_stream_join.py`` — then the port against the JAX package on the
same micro-batch stream (window words, estimates, bounds, counts, draws)
and the reservoirs against the JAX package's, ties and invalid rows
included.

Tolerances: integers (words, counts, draws, priorities) exactly; estimates
and bounds against the JAX package within rtol 1e-5; reservoir moments
within rtol 1e-5 (float32 sums over at most 64 values a stratum, added in
another order)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.relation  # noqa: F401  (repro.core re-exports a function so named)
from repro.core import sampling as jsamp
from repro.core.budget import QueryBudget as JBudget
from repro.core.window import WindowSpec as JSpec
from repro.runtime.stream_join import StreamJoinServer as JStreamServer
from torch_accuracy import (StreamGateConfig, one_torch_thread,  # noqa: F401
                            run_stream_accuracy_gate, stream_window_workload)
from repro_torch.core import sampling as tsamp
from repro_torch.core.baselines import repartition_join
from repro_torch.core.budget import QueryBudget
from repro_torch.core.cost import CostModel
from repro_torch.core.relation import (bucket_to_pow2, concatenate, from_numpy,
                                       relation)
from repro_torch.core.window import SubWindow, WindowBuffer, WindowSpec
from repro_torch.runtime.join_serve import JoinRequest, JoinServer
from repro_torch.runtime.stream_join import StreamJoinServer

jrel = sys.modules["repro.core.relation"]

MS, BM = 1024, 256   # max_strata / b_max used throughout


def _mb_arrays(seed, n=512, k1=(0, 200), k2=(150, 350)):
    r = np.random.default_rng(seed)
    return [(r.integers(*k1, n).astype(np.uint32),
             r.normal(10, 2, n).astype(np.float32)),
            (r.integers(*k2, n).astype(np.uint32),
             r.normal(5, 1, n).astype(np.float32))]


def _mb(seed, n=512, k1=(0, 200), k2=(150, 350)):
    return [relation(k, v, device="cpu")
            for k, v in _mb_arrays(seed, n, k1, k2)]


def _identical(a, b):
    return (float(a.estimate) == float(b.estimate)
            and float(a.error_bound) == float(b.error_bound)
            and float(a.count) == float(b.count)
            and float(a.dof) == float(b.dof))


def _session(srv, spec, name="t", **kw):
    kw.setdefault("budget", QueryBudget(error=0.5))
    kw.setdefault("max_strata", MS)
    kw.setdefault("b_max", BM)
    kw.setdefault("seed", 3)
    return srv.open_stream(name, spec, **kw)


def test_window_buffer_emission_and_expiry():
    spec = WindowSpec(size=3, slide=2, sub_rows=4)
    buf = WindowBuffer(spec)
    seen, gone = [], []
    for i in range(7):
        due, expired = buf.push(SubWindow(i, (), ()))
        seen += [(w, [s.index for s in subs]) for w, subs in due]
        gone += [s.index for s in expired]
    # windows at starts 0, 2, 4; each emission expires everything below the
    # NEXT window's start (0..1, 2..3, then 4..5 once window 2 is out)
    assert seen == [(0, [0, 1, 2]), (1, [2, 3, 4]), (2, [4, 5, 6])]
    assert gone == [0, 1, 2, 3, 4, 5]
    assert [s.index for s in buf.live] == [6]
    with pytest.raises(ValueError):
        WindowSpec(size=2, slide=3, sub_rows=4).validate()


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernel"])
def test_sliding_window_bit_identical_to_reregister_baseline(use_kernels):
    """Every sliding window served incrementally equals a fresh
    register-the-window-as-a-dataset query bit for bit — including the
    sigma feedback sequence across windows (same query_id, same order)."""
    spec = WindowSpec(size=4, slide=1, sub_rows=512)
    srv = StreamJoinServer(batch_slots=2)
    sess = _session(srv, spec, use_kernels=use_kernels)
    batches = [_mb(100 + i) for i in range(6)]
    done = []
    for mb in batches:
        sess.push(mb)
        srv.run()
        done += sess.drain()
    assert [r.window_id for r in done] == [0, 1, 2]

    base = JoinServer(batch_slots=1)
    for r in done:
        w = r.window_id
        rels = [bucket_to_pow2(concatenate(
            [batches[w + m][side] for m in range(spec.size)]))
            for side in range(2)]
        base.register_dataset(f"w{w}", rels)
        q = base.submit(JoinRequest(
            dataset=f"w{w}", budget=QueryBudget(error=0.5),
            query_id=sess.query_id, seed=sess.seed + 1 + w,
            filter_seed=sess.filter_seed, max_strata=MS, b_max=BM,
            use_kernels=use_kernels))
        base.run()
        assert _identical(r.result, q.result), w


def test_slide_reuses_surviving_filter_builds():
    """The acceptance contract: sliding by one sub-window builds exactly
    one new filter per input, hits the cache for every survivor, and builds
    no new stage at steady state."""
    spec = WindowSpec(size=4, slide=1, sub_rows=512)
    srv = StreamJoinServer(batch_slots=1)
    sess = _session(srv, spec)
    for i in range(4):
        sess.push(_mb(100 + i))
        srv.run()
    first = srv.diagnostics.snapshot()
    # first window: one build per (sub-window, side), nothing to reuse yet
    assert first["filter_builds"] == spec.size * 2
    assert first["filter_cache_hits"] == 0
    for i in range(4, 7):
        before = srv.diagnostics.snapshot()
        sess.push(_mb(100 + i))
        srv.run()
        after = srv.diagnostics.snapshot()
        # exactly the new sub-window builds; all survivors are cache hits
        assert after["filter_builds"] - before["filter_builds"] == 2
        assert after["filter_cache_hits"] - before["filter_cache_hits"] \
            == (spec.size - 1) * 2
        assert after["compiles"] == first["compiles"], "rebuilt a stage"
    # four windows emitted -> sub-windows 0..3 expired, words retired
    assert srv.stream_diagnostics.retired_filter_words == 4 * 2
    assert len(sess.drain()) == 4


def test_tumbling_windows_and_running_estimate():
    """Tumbling windows are disjoint: the running SumParts accumulation
    must cover the exact whole-stream join total within its CLT bound."""
    spec = WindowSpec(size=2, slide=2, sub_rows=512)
    srv = StreamJoinServer(batch_slots=1)
    sess = _session(srv, spec)
    batches = [_mb(200 + i) for i in range(8)]
    for mb in batches:
        sess.push(mb)
        srv.run()
    done = sess.drain()
    assert [r.window_id for r in done] == [0, 1, 2, 3]
    assert sess.accumulated_windows == 4

    total, cnt = 0.0, 0.0
    for w in range(4):
        rels = [bucket_to_pow2(concatenate(
            [batches[2 * w + m][side] for m in range(2)]))
            for side in range(2)]
        truth = repartition_join(rels, expr="sum")
        total += float(truth.estimate)
        cnt += float(truth.count)
    run = sess.running_estimate()
    # deterministic identity: the parts merge IS the sum of the per-window
    # estimates (windows are disjoint), and the count piece is exact
    per_window = sum(float(r.result.estimate) for r in done)
    assert float(run.estimate) == pytest.approx(per_window, rel=1e-6)
    assert sess._running[-1] == pytest.approx(cnt, rel=1e-6)
    # statistical sanity at this fixed seed (a single 95% CI realization
    # may graze the truth; 2x the half-width must contain it)
    assert abs(float(run.estimate) - total) <= 2 * float(run.error_bound)
    assert float(run.error_bound) < sum(
        float(r.result.error_bound) for r in done)


def test_window_expiry_drops_expired_tuples():
    """Tuples of an expired sub-window must not contribute: window [B, C]
    must equal the exact join of B+C alone, unmoved by A's heavy overlap."""
    spec = WindowSpec(size=2, slide=1, sub_rows=512)
    srv = StreamJoinServer(batch_slots=1)
    sess = _session(srv, spec, budget=QueryBudget())   # exact per window
    a = _mb(300, k1=(0, 50), k2=(0, 50))       # dense overlap, huge join
    b, c = _mb(301), _mb(302)
    for mb in (a, b, c):
        sess.push(mb)
        srv.run()
    w0, w1 = sess.drain()
    truth_ab = repartition_join(
        [bucket_to_pow2(concatenate([a[s], b[s]])) for s in range(2)],
        expr="sum")
    truth_bc = repartition_join(
        [bucket_to_pow2(concatenate([b[s], c[s]])) for s in range(2)],
        expr="sum")
    assert float(w0.result.estimate) == pytest.approx(
        float(truth_ab.estimate), rel=1e-5)
    assert float(w1.result.estimate) == pytest.approx(
        float(truth_bc.estimate), rel=1e-5)
    assert float(w1.result.count) == float(truth_bc.count)
    # the test is vacuous unless A actually would have moved the answer
    assert abs(float(truth_ab.estimate) - float(truth_bc.estimate)) \
        > 100 * abs(float(truth_bc.estimate)) * 1e-5


def test_admission_sheds_oldest_window_and_bounds_queue():
    spec = WindowSpec(size=1, slide=1, sub_rows=512)
    srv = StreamJoinServer(batch_slots=1, window_slots=2)
    sess = _session(srv, spec)
    notified = []
    srv.on_done = notified.append
    reqs = []
    for i in range(5):                 # emit 5 windows, never serve
        reqs += sess.push(_mb(400 + i))
    assert srv.stream_diagnostics.windows_shed == 3
    assert [r.window_id for r in reqs if r.shed] == [0, 1, 2]
    # a shed window is terminal: the completion hook fired for each
    assert [r.window_id for r in notified] == [0, 1, 2]
    assert [r.window_id for r in srv.queue] == [3, 4]
    srv.run()
    done = sess.drain()
    assert [r.window_id for r in done] == [3, 4]   # shed ones never serve
    assert all(not r.done for r in reqs[:3])
    assert srv.stream_diagnostics.windows_served == 2
    # rows beyond the sub-window slot are dropped and counted at admission
    big = _mb(500, n=700)
    sess.push(big)
    assert srv.stream_diagnostics.admission_dropped_rows == 2 * (700 - 512)


def test_shedding_mid_queue_victim_across_tenants():
    """The shed victim is rarely the queue head in a multi-tenant queue;
    removal must be by identity (JoinRequest carries tensors, so a
    value-equality removal would raise)."""
    spec = WindowSpec(size=1, slide=1, sub_rows=512)
    srv = StreamJoinServer(batch_slots=1, window_slots=1)
    sa = _session(srv, spec, name="A")
    sb = _session(srv, spec, name="B", seed=4)
    (a0,) = sa.push(_mb(600))
    (b0,) = sb.push(_mb(601))
    (b1,) = sb.push(_mb(602))      # sheds b0, which sits BEHIND a0
    assert b0.shed and not a0.shed and not b1.shed
    assert [(r.stream, r.window_id) for r in srv.queue] == [("A", 0),
                                                           ("B", 1)]
    srv.run()
    assert a0.done and b1.done and not b0.done


def test_retire_keeps_words_live_in_other_sessions():
    """Two same-geometry sessions over the SAME micro-batch stream share
    filter-cache entries ((fingerprint, num_blocks, seed) coincide); one
    session expiring a sub-window must not evict words the other still
    holds live — the other's slides must stay all-cache-hit."""
    batches = [_mb(700 + i) for i in range(4)]
    srv = StreamJoinServer(batch_slots=1)
    # same size -> same window capacity -> same num_blocks (shared entries);
    # A tumbles (expires everything at once), B slides one sub at a time
    sa = _session(srv, WindowSpec(3, 3, 512), name="A")
    sb = _session(srv, WindowSpec(3, 1, 512), name="B")
    for mb in batches[:3]:
        sb.push(mb)
        sa.push(mb)
        srv.run()
    d = srv.diagnostics.snapshot()
    # B's window 0 built each sub once; A's identical window was all hits
    assert d["filter_builds"] == 3 * 2 and d["filter_cache_hits"] == 3 * 2
    # A's tumble expired subs 0..2, but B still holds 1..2 live: only the
    # everywhere-dead sub 0 may be retired
    assert srv.stream_diagnostics.retired_filter_words == 2
    sb.push(batches[3])            # B slides: survivors 1..2 must still hit
    srv.run()
    after = srv.diagnostics.snapshot()
    assert after["filter_builds"] - d["filter_builds"] == 2
    assert after["filter_cache_hits"] - d["filter_cache_hits"] == 2 * 2


def test_fused_window_assembly_matches_reference():
    """An emitted window holds its sub-windows' rows in arrival order, each
    padded with invalid rows to its 512-row slot, and the whole padded to
    the window's pow2 bucket (``core/window.window_relations``, which the
    session calls), against a concatenation made here by hand."""
    spec = WindowSpec(size=3, slide=1, sub_rows=512)
    srv = StreamJoinServer(batch_slots=1)
    sess = _session(srv, spec)
    batches = [_mb(800 + i, n=500) for i in range(spec.size)]
    due = [sess.push(b) for b in batches]
    assert [len(d) for d in due] == [0, 0, 1]
    got = due[-1][0].rels
    for side, g in enumerate(got):
        assert g.capacity == 2048          # 3 padded slots -> pow2 bucket
        for f in range(3):
            slots = [torch.cat([b[side][f], b[side][f].new_zeros(12)])
                     for b in batches]
            want = torch.cat(slots + [slots[0].new_zeros(2048 - 3 * 512)])
            assert torch.equal(g[f], want)
        assert int(g.valid.sum()) == 3 * 500


def test_deadline_scheduling_under_backlog():
    """When the queue backs up, latency-budget queries are served before
    error-budget ones (base-server policy the streaming admission uses)."""
    rng = np.random.default_rng(0)
    n = 1 << 11
    r1 = relation(rng.integers(0, 500, n).astype(np.uint32),
                  rng.normal(10, 2, n).astype(np.float32), device="cpu")
    r2 = relation(rng.integers(400, 900, n).astype(np.uint32),
                  rng.normal(5, 1, n).astype(np.float32), device="cpu")
    srv = JoinServer(batch_slots=1, backlog_slots=0,
                     cost_model=CostModel(beta_compute=1e-7, epsilon=1e-3))
    errs = [srv.submit(JoinRequest(rels=[r1, r2],
                                   budget=QueryBudget(error=0.5),
                                   query_id=f"e{i}", seed=i, max_strata=MS,
                                   b_max=BM)) for i in range(3)]
    lat = srv.submit(JoinRequest(rels=[r1, r2],
                                 budget=QueryBudget(latency_s=0.25),
                                 query_id="lat", seed=7, max_strata=MS,
                                 b_max=BM))
    srv.step()
    assert lat.done and not any(e.done for e in errs)
    srv.run()
    assert all(e.done for e in errs)
    snap = srv.diagnostics.snapshot()
    assert snap["queue_latency_max_s"] >= snap["queue_latency_p95_s"] \
        >= snap["queue_latency_p50_s"] > 0


def _gate_backend(server, spec, cfg, **kw):
    """Adapter: one streaming session, one tumbling window per replication.
    Window 0 is pilot-allocated (fresh sigma) so it feeds the allocation
    check; later windows are sigma-fed and check coverage/bounds only."""
    state = {}

    def backend(mbs, w):
        if "sess" not in state:
            state["sess"] = server.open_stream(
                "gate", spec,
                budget=QueryBudget(error=0.5,
                                   pilot_fraction=cfg.pilot_fraction),
                max_strata=cfg.max_strata, b_max=cfg.b_max, seed=cfg.seed,
                **kw)
        sess = state["sess"]
        out = []
        for mb in mbs:
            out += sess.push(mb)
        server.run()
        (req,) = out
        assert req.done and req.window_id == w
        res = req.result
        return (float(res.estimate), float(res.error_bound),
                float(res.count), res.stats if w == 0 else None)

    return backend


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernel"])
def test_stream_accuracy_gate_single_device(use_kernels):
    """Plain and kernel sessions (the kernels' plain versions on the CPU)
    pass the per-window statistical gate; steady-state streaming reuses
    every stage it built for the first window."""
    cfg = StreamGateConfig()
    spec = WindowSpec(size=cfg.window_size, slide=cfg.window_size,
                      sub_rows=cfg.rows_per_sub)
    srv = StreamJoinServer(batch_slots=1)
    rep = run_stream_accuracy_gate(
        _gate_backend(srv, spec, cfg, use_kernels=use_kernels), cfg)
    assert rep.passed, rep.summary()
    assert rep.checked_allocation
    assert srv.stream_diagnostics.windows_emitted == cfg.windows
    assert srv.diagnostics.kernel_queries == cfg.windows * use_kernels
    assert srv.diagnostics.kernel_gather_bytes == 0.0
    assert srv.diagnostics.cache_hits > srv.diagnostics.compiles


def test_stream_kernel_windows_match_plain_within_gate_tolerance():
    """Kernel-route streaming parity: two same-seed sessions over the SAME
    micro-batch stream — one on the kernel route, one plain — agree per
    window within rtol 1e-6, share the filter-word cache (bit-identical
    words), and build no new stage after the first window in BOTH modes."""
    spec = WindowSpec(size=4, slide=1, sub_rows=512)
    srv = StreamJoinServer(batch_slots=2)
    sk = _session(srv, spec, name="kern", use_kernels=True)
    sj = _session(srv, spec, name="plain")
    batches = [_mb(900 + i) for i in range(6)]
    done_k, done_j = [], []
    for i, mb in enumerate(batches):
        sk.push(mb)
        sj.push(mb)
        srv.run()
        if i == spec.size - 1:        # both modes fully built by now
            warm = srv.diagnostics.snapshot()
        done_k += sk.drain()
        done_j += sj.drain()
    assert len(done_k) == len(done_j) == 3
    for a, b in zip(done_k, done_j):
        assert float(a.result.estimate) == pytest.approx(
            float(b.result.estimate), rel=1e-6), a.window_id
        assert float(a.result.error_bound) == pytest.approx(
            float(b.result.error_bound), rel=1e-6), a.window_id
        assert float(a.result.count) == float(b.result.count), a.window_id
    after = srv.diagnostics.snapshot()
    assert after["compiles"] == warm["compiles"], "steady state rebuilt"
    # same fingerprints + same filter_seed: one build per (sub-window, side)
    # across BOTH sessions
    assert after["filter_builds"] == len(batches) * 2
    assert srv.diagnostics.kernel_gather_bytes == 0.0
    assert srv.diagnostics.kernel_queries == 3


def test_stream_gate_rejects_window_leak():
    """Harness self-test: a backend that leaks the previous window's tuples
    into the estimate must fail the per-window gate."""
    cfg = StreamGateConfig(windows=6)
    carry = {}

    def leaky(mbs, w):
        prev = carry.get("prev")
        carry["prev"] = mbs
        rels = [bucket_to_pow2(concatenate(
            [mb[side] for mb in mbs]
            + ([mb[side] for mb in prev] if prev else [])))
            for side in range(2)]
        truth = repartition_join(rels, expr="sum")
        return (float(truth.estimate), float(truth.estimate) * 0.01,
                float(truth.count), None)

    rep = run_stream_accuracy_gate(leaky, cfg)
    assert not rep.passed, rep.summary()


def test_stream_gate_workload_truth_matches_reassembly():
    """The gate's micro-batch split must reassemble to exactly the window
    it computes truth for (guards the harness itself)."""
    cfg = StreamGateConfig(windows=1)
    mbs, (t_sum, t_cnt) = stream_window_workload(cfg, 0)
    rels = [bucket_to_pow2(concatenate([mb[side] for mb in mbs]))
            for side in range(2)]
    truth = repartition_join(rels, expr="sum")
    assert float(truth.estimate) == pytest.approx(t_sum, rel=1e-6)
    assert float(truth.count) == t_cnt


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernel"])
def test_stream_windows_match_jax(use_kernels):
    """The same micro-batch stream through the JAX package's
    StreamJoinServer (plain route) and the port's: every window's ORed
    words equal bit for bit, counts and draws exactly, estimates and
    bounds within rtol 1e-5; the same builds, hits and retirements; the
    tumbling session's running estimate within rtol 1e-5."""
    arrays = [_mb_arrays(1000 + i, n=400) for i in range(7)]
    spec_j = {"slide": JSpec(4, 1, 512), "tumble": JSpec(2, 2, 512)}
    spec_t = {"slide": WindowSpec(4, 1, 512), "tumble": WindowSpec(2, 2, 512)}
    kw = dict(max_strata=MS, b_max=BM, seed=3)
    sj = JStreamServer(batch_slots=2)
    st = StreamJoinServer(batch_slots=2)
    jsess = {n: sj.open_stream(n, s, budget=JBudget(error=0.5), **kw)
             for n, s in spec_j.items()}
    tsess = {n: st.open_stream(n, s, budget=QueryBudget(error=0.5),
                               use_kernels=use_kernels, **kw)
             for n, s in spec_t.items()}
    done_j = {n: [] for n in spec_j}
    done_t = {n: [] for n in spec_t}
    for arr in arrays:
        for n in spec_j:
            jsess[n].push([jrel.relation(k, v) for k, v in arr])
            tsess[n].push([from_numpy(k, v, np.ones(len(k), bool),
                                      device="cpu") for k, v in arr])
        sj.run()
        st.run()
        for n in spec_j:
            done_j[n] += jsess[n].drain()
            done_t[n] += tsess[n].drain()
    assert [r.window_id for r in done_t["slide"]] == [0, 1, 2, 3]
    assert [r.window_id for r in done_t["tumble"]] == [0, 1, 2]
    for n in spec_j:
        assert len(done_j[n]) == len(done_t[n])
        for a, b in zip(done_j[n], done_t[n]):
            assert a.window_id == b.window_id
            for wj, wt in zip(a._words, b._words):
                np.testing.assert_array_equal(
                    np.asarray(wj).view(np.int32), wt.numpy())
            ra, rb = a.result, b.result
            assert float(rb.count) == float(ra.count)
            np.testing.assert_array_equal(np.asarray(ra.stats.n_sampled),
                                          rb.stats.n_sampled.numpy())
            np.testing.assert_allclose(float(rb.estimate),
                                       float(ra.estimate), rtol=1e-5)
            np.testing.assert_allclose(float(rb.error_bound),
                                       float(ra.error_bound), rtol=1e-5)
    for f in ("filter_builds", "filter_cache_hits"):
        assert getattr(st.diagnostics, f) == getattr(sj.diagnostics, f), f
    for f in ("sub_windows", "windows_emitted", "windows_served",
              "retired_filter_words"):
        assert getattr(st.stream_diagnostics, f) \
            == getattr(sj.stream_diagnostics, f), f
    rj, rt = (s["tumble"].running_estimate() for s in (jsess, tsess))
    np.testing.assert_allclose(float(rt.estimate), float(rj.estimate),
                               rtol=1e-5)
    np.testing.assert_allclose(float(rt.error_bound), float(rj.error_bound),
                               rtol=1e-5)
    # the sessions' sketches folded the same rows under the same ticks
    for n in spec_j:
        for side in range(2):
            _same_reservoir(jsess[n].sketch[side], tsess[n].sketch[side])


def _same_reservoir(j, t):
    np.testing.assert_array_equal(np.asarray(j.priority).astype(np.int64),
                                  t.priority.numpy())
    np.testing.assert_array_equal(np.asarray(j.values), t.values.numpy())
    np.testing.assert_array_equal(np.asarray(j.n_seen), t.n_seen.numpy())


def _fold_arrays(seed, n, invalid=0.25):
    r = np.random.default_rng(seed)
    return (r.integers(0, 400, n).astype(np.uint32),
            r.normal(3, 2, n).astype(np.float32), r.random(n) > invalid)


_jextend = jax.jit(jsamp.reservoir_extend)


def _extend_both(jres, tres, arrays, seed, tick):
    k, v, m = arrays
    jres = _jextend(jres, jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
                    np.uint32(seed), np.uint32(tick))
    tres = tsamp.reservoir_extend(tres, torch.as_tensor(k.astype(np.int64)),
                                  torch.as_tensor(v), torch.as_tensor(m),
                                  seed, tick)
    return jres, tres


@pytest.mark.parametrize("S,cap,n", [(16, 8, 1000), (64, 64, 3000),
                                     (4, 3, 0)])
def test_reservoir_extend_merge_fill_moments_match_jax(S, cap, n):
    """Folds of batches with invalid rows, then merges (a reservoir with
    itself ties every priority; two tick-disjoint folds tie none), fill and
    moments: priorities, values, n_seen and fill equal the JAX package's,
    moments within rtol 1e-5."""
    seed = 0xFFFFFFFF
    ej, et = jsamp.reservoir_empty(S, cap), tsamp.reservoir_empty(S, cap,
                                                                 device="cpu")
    aj, at = ej, et
    for tick in range(3):
        aj, at = _extend_both(aj, at, _fold_arrays(tick, n), seed, tick)
        _same_reservoir(aj, at)
    bj, bt = _extend_both(ej, et, _fold_arrays(9, n + 7), seed, 5)
    for mj, mt in ((jsamp.reservoir_merge(aj, bj),
                    tsamp.reservoir_merge(at, bt)),
                   (jsamp.reservoir_merge(aj, aj),
                    tsamp.reservoir_merge(at, at))):
        _same_reservoir(mj, mt)
        np.testing.assert_array_equal(np.asarray(jsamp.reservoir_fill(mj)),
                                      tsamp.reservoir_fill(mt).numpy())
        for x, y in zip(jsamp.reservoir_moments(mj),
                        tsamp.reservoir_moments(mt)):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5,
                                       atol=1e-6)
    # the sketch's contract: extend(extend(E, A), B) == merge of the parts
    cj, ct = _extend_both(aj, at, _fold_arrays(9, n + 7), seed, 5)
    _same_reservoir(cj, ct)
    _same_reservoir(jsamp.reservoir_merge(aj, bj), ct)
    # every valid row of every fold was counted exactly once
    total = sum(int(_fold_arrays(t, n)[2].sum()) for t in range(3)) \
        + int(_fold_arrays(9, n + 7)[2].sum())
    assert float(ct.n_seen.sum()) == total

