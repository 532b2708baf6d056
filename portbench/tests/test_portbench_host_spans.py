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
