"""The port's crash-safe serving on the CPU, the meshless counterpart of
``tests/test_crash_safe.py``: engine snapshot/restore round trips over every
live-state leaf kind, restore merging into a live engine, the async writer
and its surfaced failure, torn and stale checkpoint directories, typed
corrupt-checkpoint errors, the fault layer (even-fleet straggler median,
``guarded_step``'s backoff and shielded callback, ``InjectedFault``), and
the drill: a replica killed mid-stream whose successor adopts its tenant
from the newest checkpoint and serves every later window bit for bit as an
uninterrupted run does, shedding nothing.

Against the JAX package: a checkpoint written by either implementation's
``save_checkpoint`` loads with the other's (same manifest, same leaf
paths), and for the same datasets and queued requests the port's
``snapshot_state`` equals the JAX engine's in its meta (dataset
fingerprints, filter-cache keys, sigmas, queue entries) and in its array
leaves after the port's representation (keys int64 holding uint32, filter
words int32 bit patterns)."""

import os
import sys
import time
from typing import NamedTuple

import numpy as np
import pytest
import torch

import repro.core.relation  # noqa: F401  (repro.core re-exports a function so named)
from repro.core import plan as jplan
from repro.core.budget import QueryBudget as JBudget
from repro.runtime import checkpoint as jckpt
from repro.runtime.join_serve import JoinRequest as JRequest
from repro.runtime.join_serve import JoinServer as JServer
from repro_torch.core.budget import QueryBudget
from repro_torch.core.plan import Plan, PlanNode
from repro_torch.core.relation import relation
from repro_torch.core.window import WindowSpec
from repro_torch.runtime.async_serve import AsyncJoinFrontDoor
from repro_torch.runtime.checkpoint import (CheckpointCorruptError,
                                            latest_step, load_checkpoint,
                                            restore_checkpoint,
                                            save_checkpoint)
from repro_torch.runtime.fault import (InjectedFault, StragglerMonitor,
                                       elastic_restore,
                                       elastic_restore_engine, guarded_step)
from repro_torch.runtime.join_serve import JoinRequest, JoinServer
from repro_torch.runtime.stream_join import StreamJoinServer
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

jrel = sys.modules["repro.core.relation"]

MS, BM = 1024, 512


def _arrays(seed, n=256):
    r = np.random.default_rng(seed)
    return [(r.integers(0, 200, n).astype(np.uint32),
             r.normal(10, 2, n).astype(np.float32)),
            (r.integers(150, 350, n).astype(np.uint32),
             r.normal(5, 1, n).astype(np.float32))]


def _mb(seed, n=256):
    return [relation(k, v, device="cpu") for k, v in _arrays(seed, n)]


def _result_key(r):
    return (float(r.result.estimate), float(r.result.error_bound),
            float(r.result.count), float(r.result.dof))


def _stream_server(**kw):
    return StreamJoinServer(batch_slots=4, **kw)


def _loaded_engine():
    """A StreamJoinServer carrying every leaf kind the snapshot covers: a
    registered dataset, a warm filter-word cache, a sigma table, a queued
    static request, and a sliding-window session with live sub-windows,
    reservoir sketches and a non-trivial running SumParts."""
    srv = _stream_server()
    srv.register_dataset("ds0", _mb(1, n=512))
    srv.sigma.table["tq/agg"] = {7: 0.25, 11: 1.5}
    sess = srv.open_stream("t", WindowSpec(size=2, slide=1, sub_rows=256),
                           budget=QueryBudget(error=0.5), max_strata=MS,
                           b_max=BM, seed=3)
    # serve window 0 so the accumulator is non-trivial, then leave window 1
    # queued and sub-windows 1..2 live in the buffer
    sess.push(_mb(100))
    sess.push(_mb(101))
    srv.run()
    sess.drain()
    sess.push(_mb(102))
    srv.submit(JoinRequest(dataset="ds0", budget=QueryBudget(error=0.5),
                           query_id="tq/agg", seed=5, max_strata=MS,
                           b_max=BM))
    return srv, sess


def test_snapshot_roundtrip_every_leaf_kind(tmp_path):
    """snapshot -> save -> load -> restore reproduces every leaf kind
    bit-exactly, and the restored engine serves its adopted queue
    bit-identical to the original serving its own."""
    srv, sess = _loaded_engine()
    flat, meta = srv.snapshot_state()
    save_checkpoint(str(tmp_path), 0, flat, extra=meta)
    flat2, meta2 = load_checkpoint(str(tmp_path), 0)

    dst = _stream_server()
    restored = dst.restore_state(flat2, meta2, device="cpu")
    assert len(restored) == len(srv.queue) == 2  # window 1 + static query

    assert list(dst.datasets) == ["ds0"]
    for a, b in zip(srv.datasets["ds0"], dst.datasets["ds0"]):
        for f in ("keys", "values", "valid"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert dst._dataset_fps["ds0"] == srv._dataset_fps["ds0"]

    # filter-word cache entries, in LRU order
    assert list(dst._filter_words) == list(srv._filter_words)
    for k in srv._filter_words:
        assert torch.equal(srv._filter_words[k], dst._filter_words[k])

    assert dst.sigma.table["tq/agg"] == {7: 0.25, 11: 1.5}

    # session: buffer bookkeeping, live sub-windows, sketch reservoirs,
    # running SumParts accumulation
    d = dst.sessions["t"]
    assert (d.buffer.arrived, d.buffer.emitted) == (3, 2)
    assert [s.index for s in d.buffer.live] == \
        [s.index for s in sess.buffer.live]
    for a, b in zip(sess.buffer.live, d.buffer.live):
        assert a.fps == b.fps
        for ra, rb in zip(a.rels, b.rels):
            assert torch.equal(ra.keys, rb.keys)
    for side in range(2):
        for f in ("priority", "values", "n_seen"):
            assert torch.equal(getattr(sess.sketch[side], f),
                               getattr(d.sketch[side], f)), f
    assert d._running == sess._running and d._running[0] != 0.0
    assert (d._acc_end, d.accumulated_windows) == (2, 1)
    assert d.overlap_ewma is None

    # both engines serve their (identical) queues bit-identically, and the
    # restored session keeps emitting from where the original would
    srv.run(), dst.run()
    sess.push(_mb(103)), d.push(_mb(103))
    srv.run(), dst.run()
    a, b = sess.drain(), d.drain()
    assert [r.window_id for r in a] == [r.window_id for r in b] == [1, 2]
    for ra, rb in zip(a, b):
        assert _result_key(ra) == _result_key(rb)
    assert dst.stream_diagnostics.windows_served \
        == srv.stream_diagnostics.windows_served


def test_restore_merges_into_live_engine(tmp_path):
    """Failover semantics: restore MERGES; the successor keeps its own
    datasets and sessions alongside the adopted ones."""
    srv, _ = _loaded_engine()
    flat, meta = srv.snapshot_state()
    save_checkpoint(str(tmp_path), 4, flat, extra=meta)

    dst = _stream_server()
    dst.register_dataset("own", _mb(2, n=512))
    dst.open_stream("mine", WindowSpec(size=1, slide=1, sub_rows=256),
                    budget=QueryBudget(error=0.5), max_strata=MS, b_max=BM)
    assert elastic_restore_engine(str(tmp_path), dst, device="cpu") == 4
    assert set(dst.datasets) == {"own", "ds0"}
    assert set(dst.sessions) == {"mine", "t"}
    assert dst.diagnostics.queries == srv.diagnostics.queries
    assert elastic_restore_engine(str(tmp_path / "empty"), dst,
                                  device="cpu") is None


def test_restore_lands_on_the_card_by_default(tmp_path):
    """Without a device the restore places every tensor on the card, and
    without a card it raises instead of landing on the CPU."""
    srv, _ = _loaded_engine()
    flat, meta = srv.snapshot_state()
    dst = _stream_server()
    if torch.cuda.is_available():
        dst.restore_state(flat, meta)
        assert all(r.keys.is_cuda for r in dst.datasets["ds0"])
        assert all(w.is_cuda for w in dst._filter_words.values())
        assert dst.sessions["t"].sketch[0].priority.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            dst.restore_state(flat, meta)


def test_async_writer_path_and_surfaced_failure(tmp_path):
    """The async writer round-trips, and a writer failure is recorded on
    the thread object instead of dying silently."""
    srv, _ = _loaded_engine()
    flat, meta = srv.snapshot_state()
    th = save_checkpoint(str(tmp_path), 9, flat, sync=False, extra=meta)
    th.join(60)
    assert not th.is_alive()
    assert th.exception is None and latest_step(str(tmp_path)) == 9
    flat2, _ = load_checkpoint(str(tmp_path), 9)
    assert set(flat2) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(flat2[k], v.numpy(), err_msg=k)

    blocked = tmp_path / "blocked"
    blocked.write_text("not a directory")
    th = save_checkpoint(str(blocked), 0, {"a": torch.zeros(3)}, sync=False)
    th.join(60)
    assert not th.is_alive()
    assert th.exception is not None


def test_host_copy_taken_before_the_writer(tmp_path):
    """save_checkpoint copies every leaf to the host before it returns: a
    tensor mutated right after an async save is written as it was."""
    t = torch.arange(1 << 16, dtype=torch.int64)
    th = save_checkpoint(str(tmp_path), 0, {"t": t}, sync=False)
    t.zero_()
    th.join(60)
    assert not th.is_alive() and th.exception is None
    flat, _ = load_checkpoint(str(tmp_path), 0)
    np.testing.assert_array_equal(flat["t"], np.arange(1 << 16))


def test_latest_step_skips_torn_dirs_and_sweeps_stale_tmp(tmp_path):
    """A mid-write kill leaves either an unrenamed .tmp-* dir or a step dir
    without a readable manifest: neither may be offered as the newest
    checkpoint, and stale tmp dirs are swept."""
    save_checkpoint(str(tmp_path), 3, {"a": np.arange(4)})
    torn = tmp_path / "step_00000008"
    torn.mkdir()
    np.save(torn / "a.npy", np.arange(4))          # leaves, no manifest
    garbled = tmp_path / "step_00000009"
    garbled.mkdir()
    (garbled / "manifest.json").write_text("{truncated")
    fresh_tmp = tmp_path / "step_00000010.tmp-abc"
    fresh_tmp.mkdir()
    stale_tmp = tmp_path / "step_00000011.tmp-def"
    stale_tmp.mkdir()
    old = time.time() - 3600
    os.utime(stale_tmp, (old, old))

    assert latest_step(str(tmp_path)) == 3
    assert fresh_tmp.exists() and not stale_tmp.exists()
    assert latest_step(str(tmp_path / "absent")) is None


def test_corrupt_checkpoints_raise_typed_errors(tmp_path):
    srv, _ = _loaded_engine()
    flat, meta = srv.snapshot_state()
    save_checkpoint(str(tmp_path), 1, flat, extra=meta)
    d = tmp_path / "step_00000001"
    leaf = next(f for f in os.listdir(d) if f.endswith(".npy"))
    (d / leaf).write_bytes(b"\x00" * 8)
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(str(tmp_path), 1)
    with pytest.raises(CheckpointCorruptError, match="manifest"):
        load_checkpoint(str(tmp_path), 77)
    save_checkpoint(str(tmp_path), 2, {"a": np.arange(4)})
    with pytest.raises(CheckpointCorruptError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), 2, {"a": np.arange(5)},
                           device="cpu")
    with pytest.raises(CheckpointCorruptError, match="missing leaf"):
        restore_checkpoint(str(tmp_path), 2, {"b": np.arange(4)},
                           device="cpu")


class _Pair(NamedTuple):
    left: torch.Tensor
    right: list


def test_restore_checkpoint_rebuilds_the_tree(tmp_path):
    """A tree of dicts, lists, tuples and NamedTuples round-trips through
    ``elastic_restore`` onto the requested device, None leaves included."""
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "pair": _Pair(torch.tensor([1, 2]), [torch.ones(2), None]),
            "t": (torch.zeros(1, dtype=torch.int32),)}
    assert elastic_restore(str(tmp_path), tree, device="cpu") \
        == (tree, 0, {})
    save_checkpoint(str(tmp_path), 5, tree, extra={"note": 1})
    got, step, extra = elastic_restore(str(tmp_path), tree, device="cpu")
    assert step == 5 and extra == {"note": 1}
    assert isinstance(got["pair"], _Pair) and got["pair"].right[1] is None
    assert isinstance(got["t"], tuple)
    for a, b in ((got["w"], tree["w"]), (got["pair"].left, tree["pair"].left),
                 (got["pair"].right[0], tree["pair"].right[0]),
                 (got["t"][0], tree["t"][0])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_straggler_median_even_fleet():
    """4-host regression: with EWMAs [1.0, 1.0, 2.2, 4.2] the true median
    is 1.6 (threshold 3.2 flags the 4.2 host)."""
    mon = StragglerMonitor(threshold=2.0)
    for host, t in [("a", 1.0), ("b", 1.0), ("c", 2.2), ("d", 4.2)]:
        for _ in range(5):
            mon.record(host, t)
    assert mon.stragglers() == ["d"]


def test_guarded_step_backoff_and_shielded_callback(monkeypatch):
    sleeps = []
    monkeypatch.setattr("repro_torch.runtime.fault.time.sleep", sleeps.append)
    calls = {"n": 0, "cb": 0}

    def flaky(state, batch):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("injected")
        return "ok"

    def bad_callback(attempt, exc):
        calls["cb"] += 1
        raise ValueError("callback bug must not mask the step error")

    out = guarded_step(flaky, None, None, retries=3, backoff_s=0.1,
                       on_failure=bad_callback)
    assert out == "ok" and sleeps == [0.1, 0.2]   # exponential, no 3rd sleep
    with pytest.raises(RuntimeError, match="failed after"):
        guarded_step(lambda s, b: 1 / 0, None, None, retries=1,
                     backoff_s=0.1, on_failure=bad_callback)
    assert sleeps == [0.1, 0.2, 0.1]              # no sleep after last try
    assert calls["cb"] == 4


def test_injected_fault_passes_retry_loop():
    calls = {"n": 0}

    def dies(state, batch):
        calls["n"] += 1
        raise InjectedFault("killed")

    with pytest.raises(InjectedFault):
        guarded_step(dies, None, None, retries=5)
    assert calls["n"] == 1                        # not retried, not wrapped


# -- the drill: kill a replica mid-stream, successor adopts its tenant ------

def _drill(tmp, ticks=8, kill_after_windows=2):
    """Uninterrupted baseline vs a 2-replica front door whose replica0 is
    killed after ``kill_after_windows`` served windows.  Returns
    (baseline {window_id: result key}, faulted ditto, shed, front-door
    snapshot, baseline sigma table, front-door sigma table)."""
    spec = WindowSpec(size=2, slide=2, sub_rows=256)
    budget = QueryBudget(error=0.5)

    base = _stream_server()
    bsess = base.open_stream("tenA", spec, budget=budget, max_strata=MS,
                             b_max=BM, seed=7)
    for t in range(ticks):
        bsess.push(_mb(100 + t))
        base.run()
    baseline = {r.window_id: _result_key(r) for r in bsess.drain()}

    out = {}
    pre_kill_ticks = kill_after_windows * spec.slide
    with AsyncJoinFrontDoor(replicas=2, engine_factory=lambda i:
                            _stream_server(), checkpoint_dir=tmp,
                            device="cpu") as fd:
        rep, _ = fd.open_stream("tenA", spec, budget=budget, max_strata=MS,
                                b_max=BM, seed=7)
        futs = []
        for t in range(pre_kill_ticks):
            futs += fd.push("tenA", _mb(100 + t))
        for f in futs:
            r = f.result(timeout=120)
            out[r.window_id] = _result_key(r)
        rep.kill_after(0)
        rep._thread.join(60)
        assert not rep._thread.is_alive()
        assert isinstance(rep.error, InjectedFault)
        # fd.push re-routes to wherever the session lives NOW: the failover
        # successor restores replica0's newest checkpoint on first touch
        for t in range(pre_kill_ticks, ticks):
            for f in fd.push("tenA", _mb(100 + t)):
                r = f.result(timeout=120)
                out[r.window_id] = _result_key(r)
        snap = fd.snapshot()
        succ = next(r for r in fd.replicas if r.error is None)
        shed = succ.call(
            lambda: succ.engine.stream_diagnostics.windows_shed).result(
                timeout=60)
        checkpoints = rep.stats["checkpoints"]
    return (baseline, out, shed, snap, checkpoints,
            dict(base.sigma.table), dict(fd.sigma.table))


def test_kill_and_resume_bit_parity(tmp_path):
    """A replica killed mid-stream, restored by a successor from its newest
    checkpoint, serves every later window of the adopted tenant bit-
    identical to an uninterrupted run: zero windows shed, and the sigma
    sequence continues exactly (identical final tables)."""
    baseline, out, shed, snap, checkpoints, bsig, fsig = _drill(str(tmp_path))
    assert snap["failovers"] == 1 and snap["failed"] == ["replica0"]
    assert shed == 0 and checkpoints > 0
    assert sorted(out) == sorted(baseline) == [0, 1, 2, 3]
    assert out == baseline
    assert fsig == bsig


# -- against the JAX package -------------------------------------------------

def test_jax_checkpoint_loads_in_the_port(tmp_path):
    tree = {"keys": np.arange(8, dtype=np.uint32), "v": [np.ones(3),
                                                         np.zeros((2, 2))],
            "flag": np.array([True, False])}
    jckpt.save_checkpoint(str(tmp_path), 3, tree, extra={"replica": "r0"})
    assert latest_step(str(tmp_path)) == 3
    flat, extra = load_checkpoint(str(tmp_path), 3)
    assert extra == {"replica": "r0"}
    assert sorted(flat) == ["flag", "keys", "v.0", "v.1"]
    for k, want in (("keys", tree["keys"]), ("v.0", tree["v"][0]),
                    ("v.1", tree["v"][1]), ("flag", tree["flag"])):
        assert flat[k].dtype == want.dtype
        np.testing.assert_array_equal(flat[k], want)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port's save (tensors of a Relation, a list, a dict) loads with
    the JAX package's load_checkpoint and, by path, its
    restore_checkpoint into a JAX tree of the same structure."""
    r = relation(np.arange(6, dtype=np.uint32), np.arange(6.0), device="cpu")
    tree = {"rel": r, "words": [torch.tensor([[-1, 5]], dtype=torch.int32)]}
    save_checkpoint(str(tmp_path), 2, tree, extra={"a": [1, 2]})
    assert jckpt.latest_step(str(tmp_path)) == 2
    flat, extra = jckpt.load_checkpoint(str(tmp_path), 2)
    assert extra == {"a": [1, 2]}
    assert sorted(flat) == ["rel.keys", "rel.valid", "rel.values", "words.0"]
    np.testing.assert_array_equal(flat["rel.keys"], np.arange(6))
    like = {"rel": jrel.Relation(*(np.zeros(6) for _ in range(3))),
            "words": [np.zeros((1, 2))]}
    got, _ = jckpt.restore_checkpoint(str(tmp_path), 2, like)
    np.testing.assert_array_equal(np.asarray(got["rel"].values),
                                  np.arange(6.0, dtype=np.float32))
    np.testing.assert_array_equal(np.asarray(got["words"][0]),
                                  np.array([[-1, 5]], np.int32))


def _jax_engine_state():
    """The same datasets, warm filter words, sigma table and queue (a
    dataset handle, a two-dataset handle, inline relations with a filter
    seed, and a plan of two 2-way nodes) on the JAX engine and on the
    port's."""
    arrs = {name: _arrays(seed, 512) for name, seed in
            (("a", 1), ("b", 2), ("c", 3))}
    inline = _arrays(9, 300)
    out = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            srv, Req, Bud = JServer(batch_slots=4), JRequest, JBudget
            rel = lambda k, v: jrel.relation(k, v)  # noqa: E731
            P, N = jplan.Plan, jplan.PlanNode
        else:
            srv, Req, Bud = JoinServer(batch_slots=4), JoinRequest, QueryBudget
            rel = lambda k, v: relation(k, v, device="cpu")  # noqa: E731
            P, N = Plan, PlanNode
        for name, a in arrs.items():
            srv.register_dataset(name, [rel(k, v) for k, v in a])
        # an exact query builds the datasets' filter words (bit-identical
        # in both packages) without touching the sigma table
        srv.submit(Req(dataset="a", budget=Bud(), query_id="warm", seed=4,
                       max_strata=MS, b_max=BM))
        srv.run()
        srv.sigma.table["t/q"] = {7: 0.25, 11: 1.5}
        srv.submit(Req(dataset="b", budget=Bud(error=0.5), query_id="t/q",
                       seed=5, max_strata=MS, b_max=BM))
        srv.submit(Req(datasets=["a", "c"], budget=Bud(error=0.5),
                       query_id="t/multi", seed=6, b_max=BM))
        srv.submit(Req(rels=[rel(k, v) for k, v in inline], budget=Bud(),
                       query_id="t/inline", seed=7, filter_seed=11,
                       max_strata=MS, b_max=BM))
        srv.submit_plan(P((N("ab", ("a", "b"), budget=Bud(error=0.5),
                             b_max=BM),
                           N("bc", ("b", "c"), budget=Bud(error=0.5),
                             b_max=BM))), query_id="pl", seed=8)
        out.append(srv.snapshot_state())
    return out


def test_snapshot_matches_jax_engine():
    (jflat, jmeta), (flat, meta) = _jax_engine_state()
    assert [(d["name"], d["n"], d["fps"]) for d in meta["datasets"]] \
        == [(d["name"], d["n"], d["fps"]) for d in jmeta["datasets"]]
    assert meta["filter_cache"] == jmeta["filter_cache"]
    assert len(meta["filter_cache"]) == 2      # dataset a, two inputs
    assert meta["sigma"] == jmeta["sigma"]
    assert meta["queue"] == jmeta["queue"]
    assert [m["plan_node"] for m in meta["queue"]] \
        == [None, None, None, "ab", "bc"]
    assert sorted(flat) == sorted(jflat)
    for k, want in jflat.items():
        got, want = flat[k].numpy(), np.asarray(want)
        if k.endswith("/keys"):
            assert got.dtype == np.int64
            got = got.astype(np.uint32)
        elif k.startswith("fw/"):
            assert got.dtype == np.int32
            got = got.view(np.uint32)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
