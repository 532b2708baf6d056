"""The Netflix Prize configuration: its generator, a tiny cut of it through
a whole run on the CPU, the float32 population the check catches, and the
readers of the draws the ``decide`` spans count."""

from __future__ import annotations

import json

import conftest
import numpy as np
import pytest
import torch

from portbench import harness
from portbench.generators import generate
from portbench.generators import netflix

ROOT = conftest.ROOT
SEED = 2**31 + 2**29 + 5
FULL = json.loads((ROOT / "portbench/configs/netflix-prize.json").read_text())
TINY = conftest.TINY["netflix-prize"]
METRICS = ("draws_per_step", "full_strata_pct")


def test_the_full_counts():
    c = netflix.rank_counts(FULL)
    assert c.shape == (17_770,) and c.dtype == np.int64
    assert int(c.sum()) == 100_480_507 == FULL["rows"][1]
    assert int(c[0]) == 232_944 == FULL["top_count"]
    assert (np.diff(c) <= 0).all() and 130 <= int(c[-1]) <= 140
    assert netflix.fitted_q(FULL) == pytest.approx(440.56, abs=0.01)


def _tiny():
    return {**FULL, **TINY}


def test_the_generator_repeats_under_the_seed():
    cfg = _tiny()
    a, b = (generate(cfg, SEED, "cpu") for _ in range(2))
    c = generate(cfg, SEED + 1, "cpu")
    for (ka, va), (kb, vb) in zip(a, b):
        assert torch.equal(ka, kb) and torch.equal(va, vb)
    assert any(not torch.equal(ka, kc) for (ka, _), (kc, _) in zip(a, c))
    (qk, qv), (tk, tv) = a
    assert [qk.shape[0], tk.shape[0]] == cfg["rows"]
    for keys in (qk, tk):
        assert keys.dtype == torch.int64
        assert int(keys.min()) >= 1 and int(keys.max()) <= cfg["movies"]
    # every movie holds its rank's ratings, the top one top_count
    per_movie = torch.bincount(tk, minlength=cfg["movies"] + 1)[1:]
    assert sorted(per_movie.tolist(), reverse=True) == \
        netflix.rank_counts(cfg).tolist()
    assert int(per_movie.max()) == cfg["top_count"]
    assert set(tv.unique().tolist()) <= {1.0, 2.0, 3.0, 4.0, 5.0}
    assert tv.dtype == qv.dtype == torch.float32
    assert bool((qv == 0).all())
    # qualifying follows the ratings: the top movie leads it too
    per_q = torch.bincount(qk, minlength=cfg["movies"] + 1)[1:]
    assert int(per_q.argmax()) == int(per_movie.argmax())


def test_ratings_follow_their_distribution():
    cfg = _tiny()
    (_, _), (_, tv) = generate(cfg, SEED, "cpu")
    share = torch.bincount(tv.to(torch.int64), minlength=6)[1:].double() \
        / tv.shape[0]
    assert np.allclose(share.numpy(), cfg["rating_p"], atol=0.01)


def _run(root):
    return harness.run_cell(root, "netflix-rating-error", SEED, 1.0, False,
                            device="cpu", log=lambda *a: None)


def test_a_tiny_run_is_correct(tiny_root):
    r = _run(tiny_root)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 8
    assert r["checks"]["strata_diff"]["value"] == 0


def test_a_traced_tiny_run_reads_its_layers(tiny_root):
    """A traced run of the cell reports the server's and the host's
    per-layer metrics that the manifest lists for it, and the draws."""
    r = harness.run_cell(tiny_root, "netflix-rating-error", SEED, 1.0, True,
                         device="cpu", log=lambda *a: None)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    for name in ("queue_p95_ms", "slots_per_step", "host_ms_per_step",
                 "prepare_ms_per_step", "sample_ms_per_step",
                 "sigma_ms_per_step", "to_host_ms_per_step",
                 "d2h_mb_per_step") + METRICS:
        assert m[name]["value"] >= 0, name
    assert m["draws_per_step"]["value"] > 0
    assert 0 < m["slots_per_step"]["value"] <= TINY["query"]["batch_slots"]


def test_a_float32_population_is_caught(tiny_root, monkeypatch):
    """The program's populations as a float32 product of the counts (the
    estimates unchanged): the verified strata's populations differ."""
    from repro_torch.runtime import join_serve as js
    (qk, _), (tk, _) = generate(_tiny(), SEED, "cpu")
    cq, ct = (torch.bincount(k, minlength=17) for k in (qk, tk))
    assert bool(((cq.float() * ct.float()).to(torch.int64) != cq * ct).any())
    sample = js.sample_stage_kernels_batched

    def f32(sorted_rels, strata, *a, **k):
        value, err, cnt, dof, stats = sample(sorted_rels, strata, *a, **k)
        pop = torch.prod(torch.clamp(strata.counts, min=0).to(torch.float32),
                         dim=1)
        return value, err, cnt, dof, stats._replace(
            population=torch.where(stats.valid, pop, 0.0))
    monkeypatch.setattr(js, "sample_stage_kernels_batched", f32)
    r = _run(tiny_root)
    assert not r["correct"]
    assert r["checks"]["strata_diff"]["value"] > 0


def _rec(events):
    return harness.Records(setup_s=1.0, window_s=2.0, requests=[], steps=[],
                           peak_bytes=0, events=events, device=None)


def _ev(name, ts, dur, tid="engine", **args):
    return {"tid": tid, "name": name, "ts": ts, "dur": dur, "args": args}


def _steps(counted=True):
    """Two sampled steps; ``counted=False`` as a program that marks no
    ``draws`` events (the commit before this configuration)."""
    ev = [_ev("step", 0.0, 0.3), _ev("decide", 0.10, 0.02, sampled=4,
                                     exact=0),
          _ev("sample", 0.13, 0.06, queries=4),
          _ev("step", 1.0, 0.2), _ev("decide", 1.10, 0.01, sampled=2,
                                     exact=0),
          _ev("sample", 1.12, 0.03, queries=2)]
    if counted:
        ev += [_ev("draws", 0.10, None, draws=20_000_000, full=3_000,
                   joinable=70_000),
               _ev("draws", 1.10, None, draws=10_000_000, full=1_000,
                   joinable=30_000)]
    ev += [dict(e, tid="q:client0#1") for e in list(ev)]
    ev.append({"tid": "engine", "name": "ingest", "ts": 0.0, "dur": None,
               "args": {}})
    return ev


def test_readers_of_the_draws():
    rec = _rec(_steps())
    read = {m: harness.reader(ROOT / "portbench", m) for m in METRICS}
    assert read["draws_per_step"](rec) == pytest.approx(30.0 / 2)
    assert read["full_strata_pct"](rec) == pytest.approx(100 * 4e3 / 1e5)
    # the instants leave the host's time a step as it was
    host = harness.reader(ROOT / "portbench", "host_ms_per_step")
    plain = _rec([e for e in _steps() if e["name"] != "draws"])
    assert host(rec) == host(plain)


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_to_read_without_the_counts(metric):
    read = harness.reader(ROOT / "portbench", metric)
    assert read(_rec([])) is None
    assert read(_rec(_steps(counted=False))) is None
    assert read(_rec([e for e in _steps() if e["tid"] != "engine"])) is None


def test_uniform_strata_read_none_in_full():
    ev = [_ev("step", 0.0, 0.3),
          _ev("decide", 0.1, 0.02, sampled=8, exact=0),
          _ev("draws", 0.1, None, draws=2_000_000, full=0, joinable=6553),
          _ev("sample", 0.13, 0.01)]
    read = harness.reader(ROOT / "portbench", "full_strata_pct")
    assert read(_rec(ev)) == 0.0
