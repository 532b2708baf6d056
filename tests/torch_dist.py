"""Rank functions and a spawn helper for the port's mesh tests.

``spawn`` runs a function on ``k`` gloo ranks (``launch/mesh.run_ranks``)
with its ``FileStore`` under the test's ``tmp_path``, every wait bounded.
The rank functions below import only torch and ``repro_torch``, so the
spawned ranks never load JAX; each returns plain Python values and numpy
arrays, which the test process compares with both packages.  Each spawn
runs many cases, since starting the ranks costs seconds.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import run_ranks

TIMEOUT_S = 120


def spawn(fn, world: int, args: tuple, tmp_path, mesh_shape=None,
          device="cpu", backend="gloo") -> list:
    """``fn(mesh, device, *args)`` on ``world`` ranks; each rank's result."""
    return run_ranks(fn, world, args, backend=backend, device=device,
                     mesh_shape=mesh_shape, timeout_s=TIMEOUT_S,
                     workdir=str(tmp_path))


def _rels(data, dev):
    from repro_torch.core.relation import relation
    return [relation(k, v, valid, device=dev) for k, v, valid in data]


def _np(rel):
    return tuple(x.cpu().numpy() for x in rel)


def _surface(r):
    return tuple(float(getattr(r, f))
                 for f in ("estimate", "error_bound", "count", "dof"))


def join_rank(mesh, dev, data, configs, shuffle_cases, join_cases):
    """Per rank and (mesh shape, join axes) of ``configs`` (a shape other
    than the run's gets a mesh of its own over the same ranks):
    ``shuffle_by_key`` of this rank's block of the first relation for each
    (cap, seed) (cap 0: the block's rows, which no bucket can overflow),
    the OR-reduced filter of each relation, and ``distributed_approx_join``
    for each case (kwargs)."""
    from repro_torch.core import bloom
    from repro_torch.core import distributed as D
    from repro_torch.core.relation import shard_to_mesh
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    rels = _rels(data, dev)
    nb = bloom.num_blocks_for(rels[0].capacity, 0.01)
    meshes = {tuple(mesh.mesh.shape): mesh}
    out = []
    for shape, axes in configs:
        m = meshes.get(tuple(shape))
        if m is None:
            m = meshes[tuple(shape)] = make_host_mesh(*shape)
        k = D.mesh_size(m, axes)
        local = shard_to_mesh(rels[0], m, axes)
        shuffles = []
        for cap, seed in shuffle_cases:
            got, sent, ovf = D.shuffle_by_key(local, k, cap or local.capacity,
                                              m, axes, seed)
            shuffles.append((_np(got), int(sent), int(ovf)))
        words = []
        for r in rels:
            lr = shard_to_mesh(r, m, axes)
            words.append(D.or_reduce(
                bloom.build(lr.keys, lr.valid, nb, 3).words, m,
                axes).cpu().numpy())
        joins = []
        for case in join_cases:
            r = D.distributed_approx_join(m, rels, join_axes=axes, **case)
            joins.append(dict(surface=_surface(r),
                              shuffled=float(r.shuffled_tuple_bytes),
                              per_rank=r.device_shuffled_bytes.tolist(),
                              overflow=int(r.bucket_overflow),
                              dropped=r.device_dropped.tolist(),
                              draws=float(r.sample_draws)))
        out.append(dict(rank=dist.get_rank(),
                        block=D.combined_axis_index(m, axes),
                        shuffles=shuffles, words=words, joins=joins))
    return out


def serve_rank(mesh, dev, data, script):
    """Rank 0 serves ``script`` (see ``run_script``) on mesh JoinServers,
    one after another; the other ranks are their workers (one worker loop
    for all of them, which returns each server's operation count)."""
    from repro_torch.runtime.join_serve import (JoinServer,
                                                close_mesh_workers,
                                                serve_mesh_worker)

    torch.set_num_threads(1)
    rels = _rels(data, dev)
    if dist.get_rank() != 0:
        return list(serve_mesh_worker(mesh, dev).ops.values())
    try:
        return run_script(lambda **kw: JoinServer(mesh=mesh, **kw), rels,
                          script)
    finally:
        close_mesh_workers()


def run_script(make_server, rels, script):
    """Serve ``script``, a list of (server kwargs, [request kwargs per
    step-run]), one server each; returns per server its results
    (estimate, bound, count, dof, dropped) by request, sigma table, the
    diagnostics' snapshot after each run and the requests' shape-class
    keys.  The requests name the dataset ``"ds"`` (``rels``)."""
    from repro_torch.core.budget import QueryBudget
    from repro_torch.runtime.join_serve import JoinRequest

    out = []
    for server_kw, runs in script:
        server_kw = dict(server_kw)
        step_once = server_kw.pop("step_once", False)
        srv = make_server(**server_kw)
        srv.register_dataset("ds", rels)
        res, snaps, classes = [], [], []
        for reqs in runs:
            qs = []
            for kw in reqs:
                kw = dict(kw)
                kw["budget"] = QueryBudget(*kw.get("budget", (None, 0.5)))
                qs.append(srv.submit(JoinRequest(dataset="ds", **kw)))
            if step_once:
                srv.step()
            else:
                srv.run()
            res += [(*_surface(q.result),
                     float(q.result.diagnostics.dist_dropped_tuples),
                     q.result.strata.keys.cpu().numpy(),
                     q.result.diagnostics.live_counts.cpu().numpy())
                    for q in qs]
            classes += [tuple(q._class) for q in qs]
            snaps.append(srv.diagnostics.snapshot())
        out.append(dict(results=res, sigma=srv.sigma.table, snaps=snaps,
                        classes=classes))
        if getattr(srv, "mesh", None) is not None:
            srv.shutdown()
    return out


def routed_bytes(data, k: int, seed: int, filter_stage: bool = True):
    """What the data says each of ``k`` blocks puts into the key shuffle
    of a join of filter seed ``seed``: TUPLE_BYTES for each live row of
    the block whose key routes to another block (rows past a bucket
    included, as the shuffle meters them), a live row being one that the
    single-device joint filter passes.  ``[k]`` float64."""
    from repro_torch.core import bloom
    from repro_torch.core.hashing import hash2
    from repro_torch.core.join import TUPLE_BYTES

    rels = _rels(data, "cpu")
    nb = bloom.num_blocks_for(max(r.capacity for r in rels), 0.01)
    jf = bloom.intersect_all([bloom.build(r.keys, r.valid, nb, seed)
                              for r in rels])
    per = np.zeros(k)
    for r in rels:
        live = r.valid & bloom.contains(jf, r.keys) if filter_stage \
            else r.valid
        block = torch.arange(r.capacity) // (r.capacity // k)
        off = live & (hash2(r.keys, seed + 101) % k != block)
        per += off.view(k, -1).sum(1).numpy()
    return per * TUPLE_BYTES


def fail_rank(mesh, dev, bad_rank):
    """Rank ``bad_rank`` raises; the others wait in a collective on it."""
    if dist.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    x = torch.ones(1)
    dist.all_reduce(x)
    return float(x)


# -- slice 8: streams, plans, snapshots and the fleet on a mesh -------------

def _from_arrays(arr, dev):
    from repro_torch.core.relation import from_numpy
    return [from_numpy(k, v, np.ones(len(k), bool), device=dev)
            for k, v in arr]


def _window(r) -> dict:
    """A served window as plain values (nothing of its request kept)."""
    res = r.result
    return dict(w=r.window_id, surface=_surface(res),
                n_sampled=None if res.stats is None
                else res.stats.n_sampled.cpu().numpy(),
                strata=res.strata.keys.cpu().numpy(),
                words=[w.cpu().numpy() for w in r._words],
                dropped=float(res.diagnostics.dist_dropped_tuples),
                cls=tuple(r._class))


def stream_windows(srv, case, dev) -> dict:
    """Stream ``case`` (one session: its spec, budget, seed, route and
    merge, its micro-batches as numpy arrays) through ``srv``, a push and
    a ``run()`` a tick; returns every window as plain values, the
    session's rolling overlap, the diagnostics and the sigma table."""
    from repro_torch.core.budget import QueryBudget
    from repro_torch.core.window import WindowSpec

    sess = srv.open_stream(case["name"], WindowSpec(*case["spec"]),
                           budget=QueryBudget(*case["budget"]),
                           max_strata=case["ms"], b_max=case["bm"],
                           seed=case["seed"], use_kernels=case["kernels"],
                           serve_mode=case["mode"])
    wins = []
    for arr in case["batches"]:
        sess.push(_from_arrays(arr, dev))
        srv.run()
        wins += [_window(r) for r in sess.drain()]
    return dict(windows=wins, ewma=sess.overlap_ewma,
                scatter_model=sess.window_scatter_bytes_model(),
                diag=srv.diagnostics.snapshot(),
                sdiag=srv.stream_diagnostics.snapshot(),
                sigma=dict(srv.sigma.table))


def stream_gate_backend(server, spec, cfg, **kw):
    """The streaming accuracy gate's backend (``tests/torch_accuracy``):
    one session, one tumbling window a replication."""
    from repro_torch.core.budget import QueryBudget
    state = {}

    def backend(mbs, w):
        if "sess" not in state:
            state["sess"] = server.open_stream(
                "gate", spec,
                budget=QueryBudget(error=0.5,
                                   pilot_fraction=cfg.pilot_fraction),
                max_strata=cfg.max_strata, b_max=cfg.b_max, seed=cfg.seed,
                **kw)
        out = []
        for mb in mbs:
            out += state["sess"].push(mb)
        server.run()
        (req,) = out
        assert req.done and req.window_id == w
        res = req.result
        return (float(res.estimate), float(res.error_bound),
                float(res.count), res.stats if w == 0 else None)
    return backend


def _report(rep, srv, **extra) -> dict:
    return dict(passed=rep.passed, summary=rep.summary(),
                alloc=rep.checked_allocation,
                dropped=srv.diagnostics.dist_dropped_tuples, **extra)


def stream_gate(mesh, mode, join_axes=None) -> dict:
    """The per-window gate on a mesh StreamJoinServer merged by ``mode``
    (psum counts within 2e-2: its buckets may drop rows)."""
    from torch_accuracy import StreamGateConfig, run_stream_accuracy_gate
    from repro_torch.core.window import WindowSpec
    from repro_torch.runtime.stream_join import StreamJoinServer

    cfg = StreamGateConfig(count_rtol=2e-2) if mode == "psum" \
        else StreamGateConfig()
    srv = StreamJoinServer(batch_slots=1, mesh=mesh, join_axes=join_axes,
                           serve_mode=mode)
    spec = WindowSpec(cfg.window_size, cfg.window_size, cfg.rows_per_sub)
    rep = run_stream_accuracy_gate(stream_gate_backend(srv, spec, cfg), cfg)
    out = _report(rep, srv, ewma=srv.sessions["gate"].overlap_ewma)
    srv.shutdown()
    return out


def plan_gate(mesh, mode, join_axes=None) -> dict:
    """The plan gate (one 3-way single-node plan a replication) on a mesh
    JoinServer merged by ``mode``."""
    from torch_accuracy import GateConfig, run_accuracy_gate
    from repro_torch.core.budget import QueryBudget
    from repro_torch.core.plan import Plan, PlanNode
    from repro_torch.runtime.join_serve import JoinServer

    cfg = GateConfig(n_rels=3, replications=12,
                     count_rtol=2e-2 if mode == "psum" else 1e-6)
    srv = JoinServer(batch_slots=1, mesh=mesh, join_axes=join_axes,
                     serve_mode=mode)

    def backend(rels, seed):
        names = []
        for i, r in enumerate(rels):
            names.append(f"rep{seed}_{i}")
            srv.register_dataset(names[-1], [r])
        plan = Plan((PlanNode(
            "node", tuple(names),
            budget=QueryBudget(error=0.5, pilot_fraction=cfg.pilot_fraction),
            max_strata=cfg.max_strata, b_max=cfg.b_max),))
        handle = srv.submit_plan(plan, query_id=f"rep{seed}", seed=seed)
        srv.run()
        res = handle.results()["node"]
        return (float(res.estimate), float(res.error_bound),
                float(res.count), res.stats)

    rep = run_accuracy_gate(backend, cfg)
    out = _report(rep, srv)
    srv.shutdown()
    return out


def same_window(g, w) -> None:
    """Two served windows (``_window``) are equal bit for bit."""
    assert g["w"] == w["w"]
    assert g["surface"] == w["surface"], g["w"]
    if w["n_sampled"] is None:
        assert g["n_sampled"] is None
    else:
        np.testing.assert_array_equal(g["n_sampled"], w["n_sampled"])
    np.testing.assert_array_equal(g["strata"], w["strata"])
    for a, b in zip(g["words"], w["words"]):
        np.testing.assert_array_equal(a, b)


def mesh_stream(mesh, dev, case, join_axes=None) -> dict:
    """``stream_windows`` on a mesh StreamJoinServer of its own (rank 0),
    with the scatter bytes it put on the wire and, once the case is
    drained, each rank's relation and word ids and the server's word ids
    of its live sub-windows."""
    import gc

    from repro_torch.core import distributed as D
    from repro_torch.runtime.stream_join import StreamJoinServer

    srv = StreamJoinServer(batch_slots=2, mesh=mesh, join_axes=join_axes)
    sent = D.COMM.bytes["scatter"]
    got = stream_windows(srv, case, dev)
    got["scattered"] = D.COMM.bytes["scatter"] - sent
    gc.collect()
    got["live"] = srv.mesh_state()
    got["word_ids"] = sorted(srv._word_ids.values())
    srv.shutdown()
    return got


def stream_rank(mesh, dev, cases, gates):
    """Rank 0 streams each of ``cases`` on a mesh StreamJoinServer of its
    own (and returns, with the windows, each rank's relation and word ids
    once the case is drained, the server's word ids of its live
    sub-windows and the scatter bytes it put on the wire), then runs the
    stream gate in each mode of ``gates``; the other ranks serve."""
    from repro_torch.runtime.join_serve import (close_mesh_workers,
                                                serve_mesh_worker)

    torch.set_num_threads(1)
    if dist.get_rank() != 0:
        return serve_mesh_worker(mesh, dev)
    try:
        return dict(cases=[mesh_stream(mesh, dev, c) for c in cases],
                    gates={mode: stream_gate(mesh, mode) for mode in gates})
    finally:
        close_mesh_workers()


PLAN_LEAVES = (("ab", ("a", "b")), ("abc", ("a", "b", "c")))


def make_plan(budget, b_max, use_kernels=False):
    from repro_torch.core.plan import Plan, PlanNode
    return Plan((PlanNode("ab", ("a", "b"), budget=budget, b_max=b_max,
                          use_kernels=use_kernels),
                 PlanNode("abc", ("ab", "c"), budget=budget, b_max=b_max,
                          use_kernels=use_kernels)))


def serve_plan(srv, data, b_max, dev="cpu", seed=7):
    """Register ``data`` as datasets a, b, c, d on ``srv`` and serve the
    two-node plan twice (plain, then the kernel route); returns each
    submission's node surfaces and strata keys, the compiled byte model and
    the plan-cache counters."""
    from repro_torch.core.budget import QueryBudget

    rels = _rels(data, dev)
    for name, r in zip("abcd", rels):
        srv.register_dataset(name, [r])
    out = []
    for i, kernels in enumerate((False, False, True)):
        plan = make_plan(QueryBudget(error=0.05), b_max, kernels)
        handle = srv.submit_plan(plan, query_id=f"p{i}", seed=seed + i)
        srv.run()
        out.append({n: (_surface(r), r.strata.keys.cpu().numpy())
                    for n, r in handle.results().items()})
    compiled = srv.compile_plan(make_plan(QueryBudget(error=0.05), b_max))
    return dict(nodes=out, model=compiled.bytes_model,
                compiles=srv.diagnostics.plan_compiles,
                hits=srv.diagnostics.plan_cache_hits,
                gathered=srv.host_gather_bytes)


def _pairs_workload():
    """(dataset, budget, query id, seed) of the fleet cases: two tenants
    interleaved, repeated ids (sigma feedback), an exact budget last."""
    out = []
    for q in range(3):
        for t in range(2):
            out.append((f"d{t}", () if q == 2 else (None, 0.5),
                        f"tenant{t}/sum{q % 2}", 40 + q))
    return out


def serve_workload(submit, workload, b_max):
    """Submit the fleet workload's requests; returns them (or futures)."""
    from repro_torch.core.budget import QueryBudget
    from repro_torch.runtime.join_serve import JoinRequest
    return [submit(JoinRequest(dataset=ds, budget=QueryBudget(*b),
                               query_id=q, seed=sd, max_strata=1024,
                               b_max=b_max)) for ds, b, q, sd in workload]


def fleet_workload_sync(make_server, data, b_max, dev="cpu"):
    """The fleet workload through one sync server: surfaces in order."""
    srv = make_server()
    for t, pair in enumerate(data):
        srv.register_dataset(f"d{t}", _rels(pair, dev))
    reqs = serve_workload(srv.submit, _pairs_workload(), b_max)
    srv.run()
    out = [_surface(r.result) for r in reqs]
    if srv.mesh is not None:
        srv.shutdown()
    return out


def fleet_workload_async(make_server, data, b_max, dev="cpu"):
    """The same through a two-replica front door of ``make_server``
    engines (futures bounded)."""
    from repro_torch.runtime.async_serve import AsyncJoinFrontDoor
    with AsyncJoinFrontDoor(replicas=2, engine_factory=lambda i:
                            make_server(), device=dev) as fd:
        for t, pair in enumerate(data):
            fd.register_dataset(f"d{t}", _rels(pair, dev))
        futs = serve_workload(fd.submit, _pairs_workload(), b_max)
        reqs = [f.result(timeout=120) for f in futs]
        steals = fd.steals
    return [_surface(r.result) for r in reqs], steals


def stream_drill(make_server, tmp, batches, ms, b_max, kill_after_windows=1,
                 dev="cpu"):
    """The streaming fault drill (``tests/test_torch_checkpoint._drill``)
    on ``make_server`` engines: an uninterrupted run, then a two-replica
    front door whose replica0 is killed once ``kill_after_windows``
    tumbling windows of 2 micro-batches are served; the successor restores
    its newest checkpoint.  Returns both runs' windows by id, the windows
    shed, the front door's failovers and whether the dead replica's server
    is shut down."""
    from repro_torch.core.budget import QueryBudget
    from repro_torch.core.window import WindowSpec
    from repro_torch.runtime.async_serve import AsyncJoinFrontDoor
    from repro_torch.runtime.fault import InjectedFault

    spec = WindowSpec(size=2, slide=2, sub_rows=256)
    kw = dict(budget=QueryBudget(error=0.5), max_strata=ms, b_max=b_max,
              seed=7)
    base = make_server()
    bsess = base.open_stream("tenA", spec, **kw)
    for arr in batches:
        bsess.push(_from_arrays(arr, dev))
        base.run()
    baseline = {r.window_id: _surface(r.result) for r in bsess.drain()}
    if base.mesh is not None:
        base.shutdown()
    out = {}
    with AsyncJoinFrontDoor(replicas=2, engine_factory=lambda i:
                            make_server(), checkpoint_dir=tmp,
                            device=dev) as fd:
        rep, _ = fd.open_stream("tenA", spec, **kw)
        futs = []
        for arr in batches[:kill_after_windows * spec.slide]:
            futs += fd.push("tenA", _from_arrays(arr, dev))
        for f in futs:
            r = f.result(timeout=120)
            out[r.window_id] = _surface(r.result)
        rep.kill_after(0)
        rep._thread.join(60)
        assert not rep._thread.is_alive()
        assert isinstance(rep.error, InjectedFault)
        for arr in batches[kill_after_windows * spec.slide:]:
            for f in fd.push("tenA", _from_arrays(arr, dev)):
                r = f.result(timeout=120)
                out[r.window_id] = _surface(r.result)
        succ = next(r for r in fd.replicas if r.error is None)
        shed = succ.call(
            lambda: succ.engine.stream_diagnostics.windows_shed).result(
                timeout=60)
        failovers = fd.failovers
        dead_stopped = rep.engine.mesh is None or rep.engine._ranks is None
    return dict(baseline=baseline, out=out, shed=shed, failovers=failovers,
                dead_stopped=dead_stopped)


def loaded_server(make_server, data, b_max, dev="cpu"):
    """A server carrying what a snapshot covers: two datasets, a warm
    filter cache, a sigma table (one served round) and, queued, a
    dataset request, an inline request, a kernel request and a plan."""
    from repro_torch.core.budget import QueryBudget
    from repro_torch.runtime.join_serve import JoinRequest

    srv = make_server()
    for t, pair in enumerate(data):
        srv.register_dataset(f"d{t}", _rels(pair, dev))
    srv.register_dataset("c", _rels(data[0], dev)[:1])
    serve_workload(srv.submit, _pairs_workload()[:2], b_max)
    srv.run()
    kw = dict(max_strata=1024, b_max=b_max)
    srv.submit(JoinRequest(dataset="d0", budget=QueryBudget(error=0.5),
                           query_id="tenant0/sum0", seed=50, **kw))
    srv.submit(JoinRequest(rels=_rels(data[1], dev),
                           budget=QueryBudget(error=0.5), query_id="inl/x",
                           seed=51, **kw))
    srv.submit(JoinRequest(dataset="d1", budget=QueryBudget(error=0.5),
                           query_id="kern/x", seed=52, use_kernels=True,
                           **kw))
    plan = make_plan(QueryBudget(error=0.05), b_max)
    srv.register_dataset("a", _rels(data[0], dev)[:1])
    srv.register_dataset("b", _rels(data[1], dev)[:1])
    srv.submit_plan(plan, query_id="pl", seed=53)
    return srv


def next_results(srv) -> list:
    """Serve what is queued; the served requests' surfaces by query id."""
    queued = list(srv.queue)
    srv.run()
    return sorted((r.query_id, _surface(r.result)) for r in queued)


def snapshot_arrays(srv):
    """A snapshot as numpy arrays (what a checkpoint holds) and meta."""
    flat, meta = srv.snapshot_state()
    return {k: v.cpu().numpy() for k, v in flat.items()}, meta


def restored_results(make_server, snap, dev="cpu") -> list:
    srv = make_server()
    srv.restore_state(*snap, device=dev)
    out = next_results(srv)
    if srv.mesh is not None:
        srv.shutdown()
    return out


def concurrent_servers(make_server, data, b_max, timeout_s=120) -> tuple:
    """Two servers of ``make_server`` serving the fleet workload at once,
    each from a thread of its own, the interpreter switching threads every
    10 us; returns both threads' surfaces and whether either was still
    running at the timeout (a hang)."""
    import sys
    import threading
    got: dict = {}

    def serve(name):
        got[name] = fleet_workload_sync(make_server, data, b_max)
    threads = [threading.Thread(target=serve, args=(n,), daemon=True)
               for n in ("x", "y")]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout_s)
    finally:
        sys.setswitchinterval(interval)
    return got, [t.is_alive() for t in threads]


def fleet_rank(mesh, dev, pairs, plan_data, batches, tmp, b_max):
    """Rank 0 of a 2-rank mesh: the plan on a mesh server, the plan gate
    in both merges, the fleet workload on a sync mesh server, through a
    front door of two mesh servers and on two mesh servers from two
    threads, the streaming drill on mesh servers, and a loaded mesh
    server's snapshot with its next results.  The other ranks serve."""
    from repro_torch.runtime.join_serve import (JoinServer,
                                                close_mesh_workers,
                                                serve_mesh_worker)
    from repro_torch.runtime.stream_join import StreamJoinServer

    torch.set_num_threads(1)
    if dist.get_rank() != 0:
        return serve_mesh_worker(mesh, dev)

    def engine():
        return JoinServer(batch_slots=4, mesh=mesh)
    try:
        out = {}
        srv = engine()
        out["plan"] = serve_plan(srv, plan_data, b_max, dev)
        srv.shutdown()
        out["plan_gates"] = {m: plan_gate(mesh, m)
                             for m in ("exact-parity", "psum")}
        out["sync"] = fleet_workload_sync(engine, pairs, b_max)
        out["async"] = fleet_workload_async(engine, pairs, b_max)
        out["threads"] = concurrent_servers(
            lambda: JoinServer(batch_slots=2, mesh=mesh), pairs, b_max)
        out["drill"] = stream_drill(
            lambda: StreamJoinServer(batch_slots=4, mesh=mesh), tmp,
            batches, 1024, b_max)
        srv = loaded_server(engine, pairs, b_max)
        out["snapshot"] = snapshot_arrays(srv)
        out["next"] = next_results(srv)
        srv.shutdown()
        return out
    finally:
        close_mesh_workers()


def layout_rank(mesh, dev, pairs, plan_data, snap, b_max, stream_cases):
    """Rank 0 of a (2, 2) mesh: ``snap`` (another mesh's snapshot)
    restored into a server joined over ``data`` (k = 2, each block on two
    ranks) and into one joined over both axes (k = 4); a loaded server
    over ``data``, its snapshot restored over both axes; the plan and
    both plan gates over both axes; each of ``stream_cases`` streamed over
    ``data`` and over both axes.  The other ranks serve."""
    from repro_torch.runtime.join_serve import (JoinServer,
                                                close_mesh_workers,
                                                serve_mesh_worker)

    torch.set_num_threads(1)
    if dist.get_rank() != 0:
        return serve_mesh_worker(mesh, dev)

    def over(*axes):
        return lambda: JoinServer(batch_slots=4, mesh=mesh, join_axes=axes)
    try:
        out = {"restored": {
            axes: restored_results(over(*axes), snap)
            for axes in (("data",), ("data", "model"))}}
        srv = loaded_server(over("data"), pairs, b_max)
        own = snapshot_arrays(srv)
        out["own_next"] = next_results(srv)
        srv.shutdown()
        out["own_restored"] = restored_results(over("data", "model"), own)
        srv = over("data", "model")()
        out["plan"] = serve_plan(srv, plan_data, b_max, dev)
        srv.shutdown()
        out["plan_gates"] = {m: plan_gate(mesh, m)
                             for m in ("exact-parity", "psum")}
        out["streams"] = {axes: {c["name"]: mesh_stream(mesh, dev, c, axes)
                                 for c in stream_cases}
                          for axes in (("data",), ("data", "model"))}
        return out
    finally:
        close_mesh_workers()


def card_rank(mesh, dev, stream_cases, plan_data, pairs, batches, tmp,
              b_max, drill):
    """Rank 0 on the card: ``stream_cases`` on mesh StreamJoinServers, the
    plan, a loaded server's snapshot with its next results, and with
    ``drill`` the streaming drill on mesh servers.  The other ranks
    serve."""
    from repro_torch.runtime.join_serve import (JoinServer,
                                                close_mesh_workers,
                                                serve_mesh_worker)
    from repro_torch.runtime.stream_join import StreamJoinServer

    if dist.get_rank() != 0:
        return serve_mesh_worker(mesh, dev)

    def engine():
        return JoinServer(batch_slots=4, mesh=mesh)
    try:
        out = {"streams": []}
        for case in stream_cases:
            srv = StreamJoinServer(batch_slots=2, mesh=mesh)
            out["streams"].append(stream_windows(srv, case, dev))
            srv.shutdown()
        srv = engine()
        out["plan"] = serve_plan(srv, plan_data, b_max, dev)
        srv.shutdown()
        srv = loaded_server(engine, pairs, b_max, dev)
        out["snapshot"] = snapshot_arrays(srv)
        out["next"] = next_results(srv)
        srv.shutdown()
        if drill:
            out["drill"] = stream_drill(
                lambda: StreamJoinServer(batch_slots=4, mesh=mesh), tmp,
                batches, 1024, b_max, dev=dev)
        return out
    finally:
        close_mesh_workers()
