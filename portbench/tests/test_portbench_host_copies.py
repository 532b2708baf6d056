"""What a served step copies to the host, read through tiny traced runs of
two cells on the CPU: in ``tpch-sf30-exact``, whose requests are all exact,
each slot's total population alone (8 bytes a slot); in ``s51-dash-error``,
whose requests all sample, the strata populations and keys besides, as
before, and each request's sigmas."""

from __future__ import annotations

import conftest
import pytest

from portbench import harness

SEED = 2**31 + 2**30 + 131


def _traced(root, cell, monkeypatch):
    """A traced tiny run of ``cell``: its result line and its records."""
    kept, records = [], harness.Records

    def keep(*a, **k):
        kept.append(records(*a, **k))
        return kept[-1]
    monkeypatch.setattr(harness, "Records", keep)
    r = harness.run_cell(root, cell, SEED, 1.0, True, device="cpu",
                         log=lambda *a: None)
    monkeypatch.setattr(harness, "Records", records)
    return r, kept[-1]


def _steps(events):
    """Each window step's slots and its copies' bytes by what they copy."""
    eng = [e for e in events if e["tid"] == "engine"]
    steps = sorted((e for e in eng if e["name"] == "step"),
                   key=lambda e: e["ts"])
    out = []
    for s in steps:
        inside = [e for e in eng if s["ts"] <= e["ts"] <= s["ts"] + s["dur"]]
        slots = next(e["args"]["slots"] for e in inside
                     if e["name"] == "batch-inputs")
        copied = {}
        for e in inside:
            if e["name"] == "to-host":
                what = e["args"]["what"]
                copied[what] = copied.get(what, 0) + e["args"]["bytes"]
        out.append((slots, copied))
    return out


@pytest.fixture
def records(monkeypatch):
    return lambda root, cell: _traced(root, cell, monkeypatch)


def test_exact_steps_copy_8_bytes_a_slot(tiny_root, records):
    r, rec = records(tiny_root, "tpch-sf30-exact")
    assert r["correct"], r["checks"]
    steps = _steps(rec.events)
    assert steps
    for slots, copied in steps:
        assert copied == {"totals": 8 * slots}
    m = r["metrics"]
    want = 8 * sum(slots for slots, _ in steps) / 1e6 / len(steps)
    assert m["d2h_mb_per_step"]["value"] == pytest.approx(want, rel=1e-12)
    assert m["d2h_mb_per_step"]["value"] < 0.001
    assert isinstance(m["to_host_ms_per_step"]["value"], float)
    assert m["to_host_ms_per_step"]["value"] >= 0


def test_sampled_steps_copy_populations_keys_and_totals(tiny_root, records):
    r, rec = records(tiny_root, "s51-dash-error")
    assert r["correct"], r["checks"]
    S = conftest.TINY["s51-2e26"]["query"]["max_strata"]
    steps = _steps(rec.events)
    assert steps
    total = 0
    for slots, copied in steps:
        assert copied["totals"] == 8 * slots
        assert copied["population"] == slots * S * 4
        assert copied["strata-keys"] == slots * S * 8
        assert set(copied) == {"totals", "population", "strata-keys",
                               "sigma"}
        total += sum(copied.values())
    assert r["metrics"]["d2h_mb_per_step"]["value"] == pytest.approx(
        total / 1e6 / len(steps), rel=1e-12)
