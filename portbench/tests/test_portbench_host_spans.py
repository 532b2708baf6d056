"""The readers of the served step's host spans (``sigma_ms_per_step``,
``to_host_ms_per_step``, ``d2h_mb_per_step``) on hand-built records."""

from __future__ import annotations

import pytest
from conftest import ROOT

from portbench import harness

BENCH = ROOT / "portbench"
METRICS = ("sigma_ms_per_step", "to_host_ms_per_step", "d2h_mb_per_step")


def _rec(events):
    return harness.Records(setup_s=1.0, window_s=2.0, requests=[], steps=[],
                           peak_bytes=0, events=events, device=None)


def _ev(name, ts, dur, tid="engine", **args):
    return {"tid": tid, "name": name, "ts": ts, "dur": dur, "args": args}


def _two_steps():
    """Two steps: a sampled one (a lookup, two copies, an update) and an
    exact one (two copies); the same spans on a request's lane and a
    replica's engine lane, which the readers leave out."""
    ev = [_ev("step", 0.0, 1.0),
          _ev("to-host", 0.20, 0.010, bytes=4_000_000, what="population"),
          _ev("to-host", 0.21, 0.020, bytes=8_000_000, what="strata-keys"),
          _ev("decide", 0.30, 0.100),
          _ev("sigma-lookup", 0.31, 0.080, strata=65536),
          _ev("finish", 0.50, 0.200),
          _ev("to-host", 0.51, 0.005, bytes=327_680, what="sigma"),
          _ev("sigma-update", 0.52, 0.120, strata=65536, kept=6000),
          _ev("step", 2.0, 0.5),
          _ev("to-host", 2.1, 0.040, bytes=2_000_000, what="population"),
          _ev("to-host", 2.2, 0.025, bytes=4_000_000, what="strata-keys")]
    for e in list(ev):
        for lane in ("q:client0#7", "replica1"):
            ev.append(dict(e, tid=lane))
    ev.append({"tid": "engine", "name": "ingest", "ts": 0.0, "dur": None,
               "args": {}})
    return ev


def test_readers_sum_the_engine_spans_over_the_steps():
    rec = _rec(_two_steps())
    read = {m: harness.reader(BENCH, m) for m in METRICS}
    assert read["sigma_ms_per_step"](rec) == pytest.approx(
        1e3 * (0.080 + 0.120) / 2)
    assert read["to_host_ms_per_step"](rec) == pytest.approx(
        1e3 * (0.010 + 0.020 + 0.005 + 0.040 + 0.025) / 2)
    assert read["d2h_mb_per_step"](rec) == pytest.approx(
        (4_000_000 + 8_000_000 + 327_680 + 2_000_000 + 4_000_000) / 1e6 / 2)


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_to_read_without_steps_or_spans(metric):
    read = harness.reader(BENCH, metric)
    ev = _two_steps()
    assert read(_rec([])) is None
    # spans but no engine step
    assert read(_rec([e for e in ev if e["name"] != "step"])) is None
    # steps but none of the metric's spans
    kind = ("sigma-lookup", "sigma-update") if metric == "sigma_ms_per_step" \
        else ("to-host",)
    assert read(_rec([e for e in ev if e["name"] not in kind])) is None
    # only other lanes hold them
    assert read(_rec([e for e in ev if e["tid"] != "engine"])) is None


@pytest.mark.parametrize("metric", METRICS)
def test_other_lanes_are_left_out(metric):
    read = harness.reader(BENCH, metric)
    ev = _two_steps()
    engine = [e for e in ev if e["tid"] == "engine"]
    assert read(_rec(ev)) == read(_rec(engine))
    # another lane's extra step does not divide the engine's sum
    more = ev + [_ev("step", 5.0, 1.0, tid="replica1")]
    assert read(_rec(more)) == read(_rec(engine))


def _nested_step(t0=0.0):
    """One step of every engine span the breakdown names, nested as the
    program nests them: ``to-host`` after ``prepare`` and inside
    ``finish``, ``sigma-lookup`` inside ``decide``."""
    return [_ev("batch-formation", t0 + 0.000, 0.005),
            _ev("step", t0 + 0.010, 0.990),
            _ev("batch-inputs", t0 + 0.020, 0.040),
            _ev("prepare", t0 + 0.060, 0.440),
            _ev("to-host", t0 + 0.500, 0.020, bytes=64, what="totals"),
            _ev("decide", t0 + 0.520, 0.180),
            _ev("sigma-lookup", t0 + 0.550, 0.100, strata=512),
            _ev("sample", t0 + 0.700, 0.100),
            _ev("finish", t0 + 0.800, 0.180),
            _ev("to-host", t0 + 0.820, 0.030, bytes=640, what="sigma"),
            _ev("sigma-update", t0 + 0.860, 0.090, strata=512, kept=500)]


def test_host_span_depth_is_found_by_time():
    ev = _nested_step() + _nested_step(2.0)
    # another lane's spans and an instant are left out
    ev += [dict(e, tid="replica1") for e in _nested_step()]
    ev.append({"tid": "engine", "name": "draws", "ts": 0.52, "dur": None,
               "args": {}})
    spans = harness._host_spans(ev, [(1.0, 2.0)])
    depth = {}
    for name, a, _, d in spans:
        depth.setdefault(name, set()).add((round(a % 2.0, 3), d))
    assert depth == {
        "batch-formation": {(0.0, 0)}, "step": {(0.01, 0)},
        "batch-inputs": {(0.02, 1)}, "prepare": {(0.06, 1)},
        "to-host": {(0.5, 1), (0.82, 2)}, "decide": {(0.52, 1)},
        "sigma-lookup": {(0.55, 2)}, "sample": {(0.7, 1)},
        "finish": {(0.8, 1)}, "sigma-update": {(0.86, 2)},
        "client": {(1.0, 0)}}
    assert len(spans) == 2 * 11 + 1


# device idle gaps, profiler clock, one inside each span of a step, and
# the span each belongs to: ten names, as many as the breakdown lists
GAPS = [((0.025, 0.035), "batch-inputs"), ((0.100, 0.120), "prepare"),
        ((0.505, 0.512), "to-host"), ((0.530, 0.540), "decide"),
        ((0.600, 0.630), "sigma-lookup"), ((0.720, 0.724), "sample"),
        ((0.805, 0.811), "finish"), ((0.830, 0.845), "to-host"),
        ((0.870, 0.920), "sigma-update"), ((0.985, 0.995), "step.host"),
        ((1.100, 1.190), "client")]


def test_each_idle_gap_goes_to_its_innermost_span():
    offset = 7.5       # the profiler's clock lags the host's by this much
    ev = [dict(e, ts=e["ts"] + offset) for e in _nested_step()]
    edges = [0.0] + [x for (a, b), _ in GAPS for x in (a, b)] + [1.4]
    ops = [("k", edges[i], edges[i + 1]) for i in range(0, len(edges), 2)]
    d = {"lo": 0.0, "hi": 1.4, "ops": ops, "steps": [], "offset": offset,
         "spans": harness._host_spans(
             ev, [(1.0 + offset, 1.2 + offset)])}
    idle = dict(harness._breakdown(d)["idle_gaps"])
    want: dict = {}
    for (a, b), name in GAPS:
        want[name] = want.get(name, 0.0) + (b - a)
    assert idle == pytest.approx(want)
    # a gap covered by the step alone reads step.host; without the step's
    # children their gaps would too
    bare = [e for e in ev if e["name"] in ("batch-formation", "step")]
    d["spans"] = harness._host_spans(bare, [(1.0 + offset, 1.2 + offset)])
    idle = dict(harness._breakdown(d)["idle_gaps"])
    assert set(idle) == {"step.host", "client"}
    assert idle["step.host"] == pytest.approx(sum(
        b - a for (a, b), name in GAPS if name != "client"))
