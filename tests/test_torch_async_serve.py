"""The port's async serving tier on the CPU, the meshless counterpart of
``tests/test_async_serve.py``: the event-loop path bit for bit equal to the
port's own synchronous server and to direct ``approx_join`` calls (with
per-``query_id`` sigma sequences, on the plain and the kernel route),
backfill never reordering one query id, deadline-aware admission through
the ingress ring, ``close`` rejecting new work, front-door tenant sharding
with and without work stealing, the dataset broadcast, async streaming
windows served and shed, and the launcher's fault drill.  Every wait is
bounded (``Future.result(timeout=)``, ``close(timeout=)``)."""

import os
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core.budget import QueryBudget
from repro_torch.core.cost import CostModel
from repro_torch.core.join import approx_join
from repro_torch.core.relation import relation
from repro_torch.core.window import WindowSpec
from repro_torch.runtime.async_serve import AsyncJoinFrontDoor, AsyncJoinServer
from repro_torch.runtime.join_serve import JoinRequest, JoinServer
from repro_torch.runtime.stream_join import StreamJoinServer
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
MS, BM = 1024, 512   # max_strata / b_max used throughout
ROUTES = pytest.mark.parametrize("use_kernels", [False, True],
                                 ids=["plain", "kernel"])


def make_pair(rng, n=1 << 11, keys1=(0, 500), keys2=(400, 900),
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


def _req(rels, budget, qid, seed, use_kernels=False):
    return JoinRequest(rels=rels, budget=budget, query_id=qid, seed=seed,
                       max_strata=MS, b_max=BM, use_kernels=use_kernels)


def _workload(rng, tenants=2, per_tenant=4):
    """(rels, budget, qid, seed) tuples: tenants interleaved, repeated
    query ids so the sigma feedback chain is exercised, an exact budget
    mixed in."""
    pairs = [make_pair(rng, mu1=5.0 + 3 * t) for t in range(tenants)]
    out = []
    for q in range(per_tenant):
        for t in range(tenants):
            budget = QueryBudget() if q == per_tenant - 1 \
                else QueryBudget(error=0.5)
            out.append((list(pairs[t]), budget, f"tenant{t}/sum{q % 2}",
                        40 + q))
    return out


def _sync_baseline(workload, use_kernels=False):
    srv = JoinServer(batch_slots=4)
    reqs = [srv.submit(_req(*w, use_kernels)) for w in workload]
    srv.run()
    return reqs


# -- single replica ----------------------------------------------------------

@ROUTES
def test_async_bit_identical_to_sync_and_direct(rng, use_kernels):
    workload = _workload(rng)
    sync = _sync_baseline(workload, use_kernels)
    srv = AsyncJoinServer(batch_slots=4)
    try:
        futs = [srv.submit(_req(*w, use_kernels)) for w in workload]
        reqs = [f.result(timeout=120) for f in futs]
        snap = srv.snapshot()
    finally:
        srv.close(timeout=60)

    for i, (r, s) in enumerate(zip(reqs, sync)):
        assert r.done and not r.shed and _identical(r.result, s.result), i
    # the first occurrence of each query id equals direct approx_join
    seen = set()
    for (rels, budget, qid, seed), r in zip(workload, reqs):
        if qid in seen:
            continue
        seen.add(qid)
        direct = approx_join(rels, budget, max_strata=MS, b_max=BM,
                             seed=seed, use_kernels=use_kernels)
        assert _identical(r.result, direct), qid
    # ingestion/dispatch/completion stamps are ordered, latencies positive
    for r in reqs:
        assert 0 < r._ingest_t <= r._dispatch_t <= r._complete_t
        assert r.queue_latency_s >= 0 and r.e2e_latency_s > 0
    assert snap["ingested"] == len(workload) and snap["backlog"] == 0
    assert snap["queries"] == len(workload)
    assert snap["kernel_queries"] == len(workload) * int(use_kernels)
    assert 0 < snap["queue_latency_p50_s"] <= snap["queue_latency_p95_s"]
    assert snap["e2e_latency_p95_s"] >= snap["queue_latency_p95_s"]
    assert set(snap["per_tenant"]) == {"tenant0", "tenant1"}
    assert snap["per_tenant"]["tenant0"]["samples"] == len(workload) // 2


def test_async_backfill_never_reorders_same_id(rng):
    """Whatever slices of the stream land via mid-flight backfill vs idle
    drain, same-``query_id`` requests dispatch in submission order and
    results stay bit-identical to the sync server."""
    workload = _workload(rng, tenants=2, per_tenant=4)
    sync = _sync_baseline(workload)
    prop_rng = np.random.default_rng(7)
    for trial in range(3):
        srv = AsyncJoinServer(batch_slots=4, linger_s=0.004)
        try:
            futs = []
            for w in workload:
                futs.append(srv.submit(_req(*w)))
                # jitter submissions so some requests arrive mid-step and
                # enter through _linger backfill, others through idle drain
                time.sleep(float(prop_rng.uniform(0, 0.004)))
            reqs = [f.result(timeout=120) for f in futs]
        finally:
            srv.close(timeout=60)
        order = {}
        for i, ((_, _, qid, _), r) in enumerate(zip(workload, reqs)):
            assert _identical(r.result, sync[i].result), (trial, i)
            order.setdefault(qid, []).append(r._dispatch_t)
        for qid, ts in order.items():
            assert ts == sorted(ts), (trial, qid, ts)


def test_async_deadline_scheduling_from_ingress(rng):
    """A latency-budget query entering through the ingress ring is promoted
    by the engine's deadline-aware scheduler: with the loop held until every
    submission is ingested, it dispatches before every error query
    submitted after it."""
    r1, r2 = make_pair(rng)
    gate_open = threading.Event()
    srv = AsyncJoinServer(batch_slots=2,
                          cost_model=CostModel(beta_compute=1e-7,
                                               epsilon=1e-3))
    try:
        gate = srv.call(lambda: gate_open.wait(60))   # hold the loop
        early = [srv.submit(_req([r1, r2], QueryBudget(error=0.5),
                                 f"t/e{i}", seed=50 + i)) for i in range(4)]
        lat = srv.submit(_req([r1, r2], QueryBudget(latency_s=2.0),
                              "t/lat", seed=99))
        late = [srv.submit(_req([r1, r2], QueryBudget(error=0.5),
                                f"t/e{4 + i}", seed=54 + i))
                for i in range(4)]
        gate_open.set()
        assert gate.result(timeout=60)
        done = [f.result(timeout=120) for f in early + [lat] + late]
    finally:
        gate_open.set()
        srv.close(timeout=60)
    lat_r, late_rs = done[4], done[5:]
    assert lat_r.done and not lat_r.shed
    assert lat_r._dispatch_t <= min(r._dispatch_t for r in late_rs)


def test_async_close_rejects_new_submissions(rng):
    r1, r2 = make_pair(rng)
    srv = AsyncJoinServer(batch_slots=2)
    f = srv.submit(_req([r1, r2], QueryBudget(error=0.5), "t/a", seed=1))
    assert f.result(timeout=120).done
    srv.close(timeout=60)
    assert not srv._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(_req([r1, r2], QueryBudget(error=0.5), "t/b", seed=2))


# -- front door: sharding + stealing -----------------------------------------

def test_front_door_steals_and_stays_bit_identical(rng):
    workload = _workload(rng, tenants=4, per_tenant=4)
    sync = _sync_baseline(workload)
    fd = AsyncJoinFrontDoor(replicas=2, batch_slots=2, device="cpu")
    try:
        # pre-assign every tenant to replica0 so replica1 starts idle and
        # MUST steal to participate
        with fd._alock:
            for t in range(4):
                fd._assign[f"tenant{t}"] = fd.replicas[0]
        futs = [fd.submit(_req(*w)) for w in workload]
        reqs = [f.result(timeout=120) for f in futs]
        snap = fd.snapshot()
    finally:
        fd.close(timeout=60)
    for i, (r, s) in enumerate(zip(reqs, sync)):
        assert _identical(r.result, s.result), i
    assert snap["steals"] > 0
    served = {name: d["queries"] for name, d in snap["replicas"].items()}
    assert served["replica1"] > 0 and sum(served.values()) == len(workload)


def test_front_door_sticky_without_stealing(rng):
    workload = _workload(rng, tenants=2, per_tenant=3)
    fd = AsyncJoinFrontDoor(replicas=2, work_stealing=False, batch_slots=2,
                            device="cpu")
    try:
        with fd._alock:
            for t in range(2):
                fd._assign[f"tenant{t}"] = fd.replicas[0]
        futs = [fd.submit(_req(*w)) for w in workload]
        for f in futs:
            assert f.result(timeout=120).done
        snap = fd.snapshot()
    finally:
        fd.close(timeout=60)
    assert snap["steals"] == 0
    assert snap["replicas"]["replica1"]["queries"] == 0
    assert snap["replicas"]["replica0"]["queries"] == len(workload)


def test_front_door_dataset_broadcast(rng):
    r1, r2 = make_pair(rng)
    fd = AsyncJoinFrontDoor(replicas=2, batch_slots=2, device="cpu")
    try:
        fd.register_dataset("shared", [r1, r2])
        for rep in fd.replicas:
            assert "shared" in rep.engine.datasets
        f = fd.submit(JoinRequest(dataset="shared",
                                  budget=QueryBudget(error=0.5),
                                  query_id="x/q", seed=3,
                                  max_strata=MS, b_max=BM))
        assert f.result(timeout=120).done
    finally:
        fd.close(timeout=60)


# -- async streaming ---------------------------------------------------------

def _mb(seed, n=512):
    r = np.random.default_rng(seed)
    return [relation(r.integers(0, 200, n).astype(np.uint32),
                     r.normal(10, 2, n).astype(np.float32), device="cpu"),
            relation(r.integers(150, 350, n).astype(np.uint32),
                     r.normal(5, 1, n).astype(np.float32), device="cpu")]


def test_async_stream_windows_bit_identical():
    spec = WindowSpec(size=4, slide=1, sub_rows=512)
    batches = [_mb(100 + i) for i in range(6)]

    base = StreamJoinServer(batch_slots=2)
    sess = base.open_stream("t", spec, budget=QueryBudget(error=0.5),
                            max_strata=MS, b_max=BM, seed=3)
    done = []
    for mb in batches:
        sess.push(mb)
        base.run()
        done += sess.drain()
    assert [r.window_id for r in done] == [0, 1, 2]

    srv = AsyncJoinServer(StreamJoinServer(batch_slots=2))
    try:
        asess = srv.open_stream("t", spec, budget=QueryBudget(error=0.5),
                                max_strata=MS, b_max=BM, seed=3)
        futs = [srv.push(asess, mb) for mb in batches]
        wins = [f.result(timeout=120) for fs in futs for f in fs]
        by_name = srv.push_by_name("t", _mb(200))
        assert [f.result(timeout=120).window_id for f in by_name] == [3]
    finally:
        srv.close(timeout=60)
    assert [r.window_id for r in wins] == [0, 1, 2]
    for a, b in zip(wins, done):
        assert not a.shed and _identical(a.result, b.result), a.window_id


def test_async_stream_shed_windows_resolve_futures():
    """Per-tenant admission sheds the oldest queued window; the shed hook
    resolves the async caller's future (with ``.shed`` set) instead of
    leaving it hanging.  All four pushes run in one loop turn, so the shed
    sequence is deterministic."""
    spec = WindowSpec(size=1, slide=1, sub_rows=512)
    srv = AsyncJoinServer(StreamJoinServer(batch_slots=4, window_slots=1))
    try:
        sess = srv.open_stream("t", spec, budget=QueryBudget(error=0.5),
                               max_strata=MS, b_max=BM, seed=3)

        def _push_all():
            pairs = []
            for i in range(4):
                for req in sess.push(_mb(200 + i)):
                    f = Future()
                    req._future = f
                    pairs.append((req, f))
            return pairs

        pairs = srv.call(_push_all).result(timeout=120)
        reqs = [f.result(timeout=120) for _, f in pairs]
        shed_count = srv.call(
            lambda: srv.engine.stream_diagnostics.windows_shed).result(
                timeout=60)
    finally:
        srv.close(timeout=60)
    assert len(reqs) == 4 and shed_count == 3
    assert [r.shed for r in reqs] == [True, True, True, False]
    assert reqs[-1].done and reqs[-1].result is not None


# -- a steal, then a death before the next checkpoint ----------------------

class _GatedServer(JoinServer):
    """A JoinServer whose steps serve nothing until its ``gate`` is set,
    and which records the query id of every request it serves."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.gate = threading.Event()
        self.served: list = []

    def step(self):
        return super().step() if self.gate.is_set() else 0

    def _run_batch(self, cls, batch):
        self.served += [r.query_id for r in batch]
        super()._run_batch(cls, batch)


def test_steal_then_death_before_a_checkpoint_serves_each_query_once(
        rng, tmp_path):
    """Replica0 holds two tenants' requests, all in its newest checkpoint;
    replica1 steals one tenant, and replica0 dies before it checkpoints
    again.  The successor restores that checkpoint: it must serve the
    other tenant's requests (whose futures failed with replica0) and not
    the stolen ones, which the thief serves.  Every query id is served
    once, and the live fleet's queries equal the futures returned plus the
    futures failed (the JAX package's fleet serves the stolen ones twice
    here).  The locks held make the interleaving the same on every run."""
    from repro_torch.runtime.fault import InjectedFault

    fd = AsyncJoinFrontDoor(replicas=2, work_stealing=False,
                            engine_factory=lambda i: _GatedServer(
                                batch_slots=4),
                            checkpoint_dir=str(tmp_path), device="cpu")
    rep0, rep1 = fd.replicas
    rep1.engine.gate.set()
    pair = list(make_pair(rng))
    try:
        with fd._alock:
            fd._assign["ta"] = fd._assign["tb"] = rep0
        futs = {f"{t}/q{i}": fd.submit(_req(pair, QueryBudget(error=0.5),
                                            f"{t}/q{i}", 10 + i))
                for t in ("ta", "tb") for i in range(3)}
        deadline = time.monotonic() + 60
        while True:         # replica0's newest checkpoint holds all six
            with rep0._elock:
                if len(rep0.engine.queue) == 6 and not rep0._ingress \
                        and not rep0._dirty:
                    break
            assert time.monotonic() < deadline, "replica0 never checkpointed"
            time.sleep(0.01)
        with fd._alock, rep0._elock:
            rep0._ckpt_writer.join(60)
            fd.work_stealing = True
            assert fd._steal_for(rep1)                 # tenant ta moves
            assert fd._assign["ta"] is rep1
            fault = InjectedFault("replica0 dies before its next checkpoint")
            rep0.error = fault
            rep0._fail_pending(fault)
            assert fd.maybe_failover() == 1
        returned, failed = [], []
        for qid, f in futs.items():
            try:
                returned.append(f.result(timeout=120).query_id)
            except InjectedFault:
                failed.append(qid)
        deadline = time.monotonic() + 120
        while rep1.backlog() and time.monotonic() < deadline:
            time.sleep(0.01)
        served = rep1.call(lambda: list(rep1.engine.served)).result(60)
        queries = rep1.snapshot()["queries"]
    finally:
        fd.close(timeout=60)
    assert sorted(returned) == [f"ta/q{i}" for i in range(3)]
    assert sorted(failed) == [f"tb/q{i}" for i in range(3)]
    assert sorted(served) == sorted(futs)             # each id once
    assert queries == len(returned) + len(failed)


# -- the launcher's fault drill ----------------------------------------------

def test_launcher_fault_drill_on_the_cpu(tmp_path):
    """``--async --replicas 2 --checkpoint-dir --kill-after 2`` on the CPU:
    replica0 dies after two steps, one failover, and the live fleet's
    queries equal the futures returned plus the futures failed (the
    successor re-serves every failed request from the checkpoint, and its
    restored counters carry what replica0 served before)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.join_serve", "--device",
         "cpu", "--async", "--replicas", "2", "--checkpoint-dir",
         str(tmp_path / "ckpt"), "--kill-after", "2", "--tenants", "4",
         "--queries-per-tenant", "4", "--base-n", "512"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**env, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    m = re.search(r"failovers=(\d+) futures_failed=(\d+) .*live fleet "
                  r"queries=(\d+) = (\d+) returned \+ (\d+) failed",
                  out.stdout)
    assert m, out.stdout
    failovers, failed, fleet, returned, failed2 = map(int, m.groups())
    # replica0 keeps its tenants until the failover (the drill steals
    # nothing meanwhile); none of their queries may be lost or served twice
    assert failovers == 1 and failed == failed2
    assert returned + failed == 16
    assert fleet == returned + failed
    assert os.listdir(tmp_path / "ckpt" / "replica0")
