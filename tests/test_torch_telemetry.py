"""The port's telemetry layer: the metrics registry as the single store
behind the server's diagnostics snapshot, bounded span tracing with Chrome
trace-event export, per-path byte reconciliation, and the trace_dump
reader — on the CPU, with the port's JoinServer.  The same recorded
operations through the JAX package's telemetry (it needs numpy only) give
the same exports, byte for byte."""

import json

import numpy as np
import pytest

from repro.launch import trace_dump as jdump
from repro.runtime import telemetry as jtel
from repro_torch.core.budget import QueryBudget
from repro_torch.core.relation import relation
from repro_torch.launch import trace_dump as tdump
from repro_torch.launch.trace_dump import summarize
from repro_torch.runtime import telemetry as ttel
from repro_torch.runtime.join_serve import (JoinRequest, JoinServer,
                                            ServerDiagnostics)
from repro_torch.runtime.telemetry import (NULL_SPAN, MetricsRegistry, Tracer,
                                           chrome_trace, dump_chrome_trace,
                                           latency_pcts, span_tree,
                                           validate_chrome_trace)
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

MS, BM = 512, 256   # max_strata / b_max used throughout
ERR = QueryBudget(error=0.5)


def _mb(seed, n=256):
    r = np.random.default_rng(seed)
    return [relation(r.integers(0, 200, n).astype(np.uint32),
                     r.normal(10, 2, n).astype(np.float32), device="cpu"),
            relation(r.integers(150, 350, n).astype(np.uint32),
                     r.normal(5, 1, n).astype(np.float32), device="cpu")]


def _req(seed, qid="t0/q", **kw):
    kw.setdefault("rels", _mb(seed))
    kw.setdefault("budget", ERR)
    return JoinRequest(query_id=qid, seed=seed, max_strata=MS, b_max=BM,
                       **kw)


def _identical(a, b):
    return all(float(getattr(a, f)) == float(getattr(b, f))
               for f in ("estimate", "error_bound", "count", "dof"))


# -- metrics registry --------------------------------------------------------

def test_registry_get_or_create_and_kind_mismatch():
    reg = MetricsRegistry()
    c = reg.counter("hits")
    c.inc()
    c.inc(2)
    assert reg.counter("hits") is c and c.value == 3
    assert "hits" in reg and "nope" not in reg
    with pytest.raises(TypeError):
        reg.gauge("hits")          # same name, different kind
    h = reg.histogram("lat", cap=3)
    for v in (1.0, 2.0, 3.0, 4.0):
        h.observe(v)
    assert h.samples == [2.0, 3.0, 4.0]      # ring bounded at cap
    assert h.count == 4 and h.total == 10.0  # cumulative survive the ring


def test_registry_to_dict_and_prometheus():
    reg = MetricsRegistry()
    reg.counter("serve_queries").inc(5)
    reg.gauge("load").set(0.5)
    reg.gauge("per_device.bytes").set(np.array([1.0, 2.0]))
    h = reg.histogram("lat")
    h.observe(1.0)
    d = reg.to_dict()
    assert d["serve_queries"] == 5 and d["load"] == 0.5
    assert d["per_device.bytes"] == [1.0, 2.0]
    assert d["lat"]["count"] == 1
    json.dumps(d)                            # JSON-able view
    text = reg.prometheus(prefix="repro")
    assert "# TYPE repro_serve_queries counter" in text
    assert "repro_serve_queries 5.0" in text
    assert 'repro_per_device_bytes{device="0"} 1.0' in text
    assert 'repro_per_device_bytes{device="1"} 2.0' in text
    assert 'repro_lat{quantile="0.5"} 1.0' in text
    assert "repro_lat_count 1" in text and "repro_lat_sum 1.0" in text
    reg.gauge("unset")                       # never-set gauges are omitted
    assert "unset" not in reg.prometheus()


def test_latency_pcts_schema():
    z = latency_pcts([], "queue_latency")
    assert z == {"queue_latency_p50_s": 0.0, "queue_latency_p95_s": 0.0,
                 "queue_latency_max_s": 0.0}
    p = latency_pcts([1.0, 2.0, 3.0], "x")
    assert p["x_p50_s"] == 2.0 and p["x_max_s"] == 3.0


# -- tracer ------------------------------------------------------------------

def test_tracer_disabled_noop_and_ring_bounded():
    off = Tracer(enabled=False)
    assert off.span("s") is NULL_SPAN
    with off.span("s") as s:
        s.set(k=1)                            # no-op, no error
    off.instant("i")
    off.event("e", 0.0, 1.0)
    off.note_recon({"path": "x", "pairs": []})
    assert not off.events and not off.recon and off._seq == 0
    on = Tracer(enabled=True, capacity=8)
    for i in range(20):
        on.instant(f"i{i}")
    assert len(on.events) == 8                # ring bounded
    assert on._seq == 20                      # ids keep advancing
    assert [e["name"] for e in on.events][0] == "i12"
    with on.span("work", k=1) as sp:
        sp.set(j=2)
    assert on.events[-1]["name"] == "work"
    assert on.events[-1]["args"] == {"k": 1, "j": 2}


def test_tracer_state_adopt_max_merge():
    a, b = Tracer(enabled=True), Tracer(enabled=True)
    for _ in range(5):
        a.next_id()
    b.next_id()
    st = a.state()
    json.dumps(st)
    b.adopt(st)
    assert b._seq == 5
    a.adopt(b.state())                        # max-merge: never regresses
    assert a._seq == 5
    assert b.next_id() == 6                   # successor ids stay unique


def test_span_tree_containment_and_zero_dur_leaves():
    tr = Tracer(enabled=True)
    tr.event("outer", 0.0, 10.0, tid="L")
    tr.event("inner", 1.0, 4.0, tid="L")
    tr.event("leaf", 2.0, 0.0, tid="L")       # zero-dur marker inside inner
    tr.event("mark", 2.0, 0.0, tid="L")       # same ts: must NOT nest in leaf
    tr.event("sibling", 6.0, 2.0, tid="L")
    tr.event("other-lane", 0.0, 1.0, tid="M")
    tr.instant("note", tid="L")               # instants are not tree nodes
    forest = span_tree(tr.events)
    assert {n["name"] for n in forest} == {"outer", "other-lane"}
    outer = next(n for n in forest if n["name"] == "outer")
    assert [c["name"] for c in outer["children"]] == ["inner", "sibling"]
    inner = outer["children"][0]
    assert [c["name"] for c in inner["children"]] == ["leaf", "mark"]
    assert all(not c["children"] for c in inner["children"])


def test_chrome_trace_export_and_validation():
    tr = Tracer(enabled=True, tags={"replica": "r0"})
    tr.event("work", 1.0, 0.5, cat="serve", tid="engine", k=1)
    tr.instant("done", tid="engine")
    obj = chrome_trace(tr, reconciliation={"paths": {}, "server": [],
                                           "queries": []})
    n = validate_chrome_trace(obj)
    assert n == len(obj["traceEvents"])
    assert {"X", "i", "M"} <= {e["ph"] for e in obj["traceEvents"]}
    x = next(e for e in obj["traceEvents"] if e["ph"] == "X")
    assert x["ts"] == pytest.approx(1.0e6)    # microseconds
    assert x["args"]["replica"] == "r0"
    assert obj["displayTimeUnit"] == "ms"
    for bad in ({"traceEvents": [{"ph": "Z"}]}, [],
                {"traceEvents": [{"ph": "X", "name": "a", "pid": 1,
                                  "tid": 1, "ts": 0, "dur": -1}]}):
        with pytest.raises(ValueError):
            validate_chrome_trace(bad)


def _record(tel):
    """The same operations on one package's telemetry: registry, tracer,
    reconciliation.  Returns every export."""
    reg = tel.MetricsRegistry()
    reg.counter("serve_queries").inc(3)
    reg.gauge("per_device").set(np.array([1.0, 2.5]))
    h = reg.histogram("lat", cap=4)
    for v in (0.5, 0.25, 2.0, 1.0, 0.125):
        h.observe(v)
    tr = tel.Tracer(enabled=True, capacity=16, tags={"replica": "r1"})
    tr.event("step", 1.0, 2.0, cat="serve", tid="engine", batch=2)
    tr.event("prepare", 1.5, 0.5, cat="stage", tid="engine")
    tr.event("mark", 1.75, 0.0, cat="stage", tid="engine")
    tr.instant("complete", cat="query", tid="q:a#1", ts=3.0, query_id="a")
    recs = [{"path": "kernel", "pairs": [
        tel.recon_pair("live_tuple_bytes", 800.0, None),
        tel.recon_pair("filter_exchange_bytes", 96.0, 100.0)]}]
    rep = tel.reconciliation_report(
        recs, [tel.recon_pair("kernel_gather_bytes", 0.0, None)])
    trace = tel.chrome_trace(tr, reconciliation=rep)
    return (reg.to_dict(), reg.prometheus("repro"), trace,
            tel.span_tree(tr.events), tel.format_reconciliation(rep),
            tel.latency_pcts(h.samples, "lat"))


def test_exports_match_the_reference_telemetry():
    ours, ref = _record(ttel), _record(jtel)
    for a, b in zip(ours, ref):
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert tdump.summarize(ours[2]) == jdump.summarize(ref[2])


# -- diagnostics on the registry ---------------------------------------------

def test_server_snapshot_readonly_idempotent():
    srv = JoinServer(batch_slots=2)
    for s in range(3):
        srv.submit(_req(s, qid=f"t{s % 2}/q"))
    srv.run()
    snap1 = srv.diagnostics.snapshot()
    snap2 = srv.diagnostics.snapshot()
    assert snap1 == snap2                     # idempotent, mutates nothing
    assert snap1["queries"] == 3
    assert len(srv.diagnostics.queue_latencies) == 3  # rings untouched
    json.dumps(snap1)                         # JSON-able
    assert srv.diagnostics.queries == 3
    assert len(srv.diagnostics.tenant_latencies) == 2
    text = srv.diagnostics.prometheus()
    assert "repro_serve_queries 3.0" in text
    assert "repro_serve_queue_latencies_count 3" in text
    srv.diagnostics.reset_latencies()
    assert srv.diagnostics.queue_latencies == []
    assert srv.diagnostics.snapshot()["queries"] == 3


def test_diagnostics_schema_matches_the_reference():
    """The snapshot of an idle server has the reference's keys, values and
    types; the server's registry names the same metrics."""
    from repro.runtime.join_serve import ServerDiagnostics as JDiag
    ours, ref = ServerDiagnostics(), JDiag()
    for d in (ours, ref):
        d.note_latency("a", 0.25, 0.5, 8)
    assert ours.snapshot() == ref.snapshot()
    assert [m.name for m in ours.registry] == [m.name for m in ref.registry]


def test_tenant_rings_lru_bounded():
    d = ServerDiagnostics(tenant_cap=4)
    for i in range(4):
        d.note_latency(f"t{i}", 0.1, 0.2, cap=16)
    d.note_latency("t0", 0.1, 0.2, cap=16)    # touch t0: now most recent
    d.note_latency("t4", 0.1, 0.2, cap=16)    # evicts t1 (LRU), not t0
    assert set(d.tenant_latencies) == {"t0", "t2", "t3", "t4"}
    assert d.tenant_evictions == 1
    for i in range(5, 10):
        d.note_latency(f"t{i}", 0.1, 0.2, cap=16)
    assert len(d.tenant_latencies) == 4
    assert d.tenant_evictions == 6
    assert len(d.snapshot()["per_tenant"]) == 4


# -- end-to-end span trees + reconciliation per serving path -----------------

def _roots(srv, qid):
    return [n for n in srv.query_trace(qid) if n["name"] == "query"]


def _span_names(node, acc=None):
    acc = set() if acc is None else acc
    acc.add(node["name"])
    for c in node["children"]:
        _span_names(c, acc)
    return acc


@pytest.mark.parametrize("use_kernels,path", [(False, "single"),
                                              (True, "kernel")])
def test_span_tree_and_recon(use_kernels, path):
    tr = Tracer(enabled=True)
    srv = JoinServer(batch_slots=2, tracer=tr)
    srv.submit(_req(0, qid="t0/q", use_kernels=use_kernels))   # sampled
    srv.submit(_req(1, qid="t1/q", budget=QueryBudget(),       # exact
                    use_kernels=use_kernels))
    srv.run()
    for qid, stage in (("t0/q", "sample"), ("t1/q", "exact")):
        roots = _roots(srv, qid)
        assert len(roots) == 1
        assert roots[0]["args"]["path"] == path
        names = _span_names(roots[0])
        assert {"query", "queued", "execute", "prepare", stage,
                "filter-exchange", "shuffle"} <= names
        assert {"queued", "execute"} <= {c["name"]
                                         for c in roots[0]["children"]}
    compile_ev = [e for e in tr.events if e["name"] == "compile"]
    assert compile_ev and compile_ev[0]["args"]["stage"] == "prepare"
    for name in ("ingest", "complete"):   # instants bracket every query
        assert sum(e["name"] == name for e in tr.events) == 2
    validate_chrome_trace(chrome_trace(tr))
    rep = srv.reconciliation_report()
    agg = rep["paths"][path]
    assert agg["filter_exchange_bytes"]["modeled"] > 0
    assert agg["live_tuple_bytes"]["measured"] is None   # no wire meter
    assert agg["live_tuple_bytes"]["queries"] == 2
    assert [p["name"] for p in rep["server"]] == ["filter_exchange_bytes"]
    assert srv.diagnostics.filter_exchange_bytes_model > 0


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel"])
def test_tracing_off_serves_bit_identical_and_silent(use_kernels):
    on = JoinServer(batch_slots=2, tracer=Tracer(enabled=True))
    off = JoinServer(batch_slots=2)
    a = on.submit(_req(5, qid="t/q", use_kernels=use_kernels))
    b = off.submit(_req(5, qid="t/q", use_kernels=use_kernels))
    on.run()
    off.run()
    assert _identical(a.result, b.result)
    assert not off.tracer.events and not off.tracer.recon
    assert off.query_trace("t/q") == []
    assert off.reconciliation_report()["paths"] == {}


# -- the served step's host spans ----------------------------------------------

HOST_SPANS = ("batch-inputs", "to-host", "decide", "sigma-lookup", "finish",
              "sigma-update")


def _host_step(use_kernels, tracer, trace=True):
    """A server whose registry holds ``t0/q``'s sigmas (an untraced first
    request), then one step of a sampled ``t0/q`` and an exact ``t1/q``,
    traced if ``trace``; returns (server, sampled, exact request)."""
    tracer.enabled = False
    srv = JoinServer(batch_slots=2, tracer=tracer)
    srv.submit(_req(3, qid="t0/q", use_kernels=use_kernels))
    srv.run()
    assert srv.sigma.has("t0/q")
    tracer.enabled = trace
    a = srv.submit(_req(4, qid="t0/q", use_kernels=use_kernels))
    b = srv.submit(_req(5, qid="t1/q", budget=QueryBudget(),
                        use_kernels=use_kernels))
    assert srv.step() == 2
    return srv, a, b


def _engine_tree(tr):
    return span_tree(e for e in tr.events if e["tid"] == "engine")


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel"])
def test_step_host_spans_nest_and_count(use_kernels):
    from repro_torch.core.join import measured_sigma
    tr = Tracer(enabled=True)
    srv, a, b = _host_step(use_kernels, tr)
    roots = _engine_tree(tr)
    assert [n["name"] for n in roots] == ["batch-formation", "step"]
    step = roots[1]
    kids = [c["name"] for c in step["children"]]
    assert kids == ["batch-inputs", "compile", "prepare", "to-host",
                    "to-host", "to-host", "decide", "sample", "exact",
                    "finish"]
    by = {}
    for c in step["children"]:
        by.setdefault(c["name"], []).append(c)
    assert not by["batch-inputs"][0]["children"]
    assert by["batch-inputs"][0]["args"]["slots"] == 2
    assert by["batch-inputs"][0]["args"]["real"] == 2
    decide, finish = by["decide"][0], by["finish"][0]
    assert (decide["args"]["sampled"], decide["args"]["exact"]) == (1, 1)
    assert [c["name"] for c in decide["children"]] == ["sigma-lookup"]
    assert finish["args"]["requests"] == 2
    assert [c["name"] for c in finish["children"]] == ["to-host",
                                                       "sigma-update"]
    # counts at the boundaries: the slot's strata, the copies' bytes
    res = a.result
    S = res.strata.keys.shape[0]
    assert S == MS
    totals, pop, keys = (c["args"] for c in by["to-host"])
    assert (totals["what"], pop["what"], keys["what"]) == (
        "totals", "population", "strata-keys")
    # each slot's exact total population: int64, 8 bytes a slot
    assert totals["bytes"] == 2 * 8
    # the exact int64 populations cross to the host as float32
    assert pop["bytes"] == 2 * S * 4
    assert keys["bytes"] == 2 * S * res.strata.keys.element_size()
    ok = res.stats.valid & (res.stats.n_sampled > 1)
    sig = finish["children"][0]["args"]
    assert sig["what"] == "sigma"
    assert sig["bytes"] == measured_sigma(res.stats).nbytes + ok.nbytes
    look = decide["children"][0]["args"]
    upd = finish["children"][1]["args"]
    assert look["strata"] == upd["strata"] == S
    assert upd["kept"] == int(ok.sum()) > 0
    for args in (look, upd):
        assert args["query_id"] == "t0/q" and args["qspan"] == a._span_id
    assert a._span_id is not None and b._span_id != a._span_id
    # the host part is the step less its direct children
    assert sum(c["dur"] for c in step["children"]) <= step["dur"]
    validate_chrome_trace(chrome_trace(tr))


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel"])
def test_sigma_spans_count_hits_and_new_keys(use_kernels):
    """A traced step's ``sigma-lookup`` carries ``hits`` (the request's
    strata keys the registry held) and its ``sigma-update`` ``new`` (the
    kept keys it did not hold), as the registry before the step implies."""
    tr = Tracer(enabled=False)
    srv = JoinServer(batch_slots=2, tracer=tr)
    srv.submit(_req(3, qid="t0/q", use_kernels=use_kernels))
    srv.run()
    before = dict(srv.sigma.table["t0/q"].items())
    tr.enabled = True
    a = srv.submit(_req(4, qid="t0/q", rels=_mb(3), use_kernels=use_kernels))
    assert srv.step() == 1
    keys = a.result.strata.keys.numpy()
    ok = (a.result.stats.valid & (a.result.stats.n_sampled > 1)).numpy()
    look, = [e["args"] for e in tr.events if e["name"] == "sigma-lookup"]
    upd, = [e["args"] for e in tr.events if e["name"] == "sigma-update"]
    assert look["hits"] == int(np.isin(keys, list(before)).sum()) > 0
    assert look["hits"] < look["strata"] == len(keys)
    new = set(keys[ok].tolist()) - set(before)
    assert upd["new"] == len(new) > 0
    assert upd["kept"] == int(ok.sum())
    assert len(srv.sigma.table["t0/q"]) == len(before) + len(new)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel"])
def test_step_spans_mirror_onto_the_profiler(use_kernels):
    from torch.profiler import ProfilerActivity, profile
    tr = Tracer(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _host_step(use_kernels, tr)
    engine = [e["name"] for e in tr.events
              if e["tid"] == "engine" and e["dur"] is not None]
    assert set(HOST_SPANS) <= set(engine)
    mirrored = [e.name for e in prof.events() if e.name in set(engine)]
    assert sorted(mirrored) == sorted(engine)
    # the ranges are not in the ring: the same step unprofiled records the
    # same events
    plain = Tracer(enabled=True)
    _host_step(use_kernels, plain)
    assert [(e["name"], e["tid"]) for e in plain.events] == \
        [(e["name"], e["tid"]) for e in tr.events]
    # with the tracer disabled nothing is mirrored, and nothing recorded
    off = Tracer(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _host_step(use_kernels, off, trace=False)
    assert not {e.name for e in prof.events()} & set(engine)
    assert not off.events


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel"])
def test_untraced_step_copies_only_its_inputs(use_kernels, monkeypatch):
    """With tracing off a step of a sampled and an exact request copies to
    the host each slot's live rows a side (the sorts' sizes: one copy of
    the batch on the kernel route, one a slot on the plain route, in the
    warm-up's prepare and in the step's), each
    slot's total population, the strata populations and keys, and the
    sampled request's sigmas and validity: none for telemetry."""
    import torch
    srv = JoinServer(batch_slots=2)
    srv.submit(_req(3, qid="t0/q", use_kernels=use_kernels))
    srv.run()
    srv.submit(_req(4, qid="t0/q", use_kernels=use_kernels))
    srv.submit(_req(5, qid="t1/q", budget=QueryBudget(),
                    use_kernels=use_kernels))
    copies = []
    cpu = torch.Tensor.cpu

    def counted(t, *a, **k):
        copies.append(tuple(t.shape))
        return cpu(t, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    assert srv.step() == 2
    # the live rows, read by the width's first prepare (its warm-up) and
    # by the step's
    live = ([(2, 2)] if use_kernels else [(2,), (2,)]) * 2
    assert copies == live + [(2,), (2, MS), (2, MS), (MS,), (MS,)]


# -- trace_dump CLI surface --------------------------------------------------

def test_dump_and_summarize(tmp_path, capsys, monkeypatch):
    tr = Tracer(enabled=True)
    srv = JoinServer(batch_slots=2, tracer=tr)
    srv.submit(_req(0, qid="t0/q", use_kernels=True))
    srv.run()
    path = str(tmp_path / "trace.json")
    n = dump_chrome_trace(tr, path,
                          reconciliation=srv.reconciliation_report())
    with open(path) as fh:
        obj = json.load(fh)
    assert validate_chrome_trace(obj) == n
    text = summarize(obj)
    assert "events" in text and "by category:" in text
    assert "byte reconciliation" in text
    assert "filter_exchange_bytes" in text
    monkeypatch.setattr("sys.argv", ["trace_dump", path, "--validate-only"])
    tdump.main()
    assert f"valid chrome trace, {n} events" in capsys.readouterr().out
