"""JoinServer driver: multi-tenant batched ApproxJoin serving on the card.

Builds synthetic tenant datasets in two capacity shape classes on the
device, registers them as named handles, submits an interleaved query
stream (error-budget, latency-budget and exact tenants, every request on
the kernel route), and prints throughput plus the server's stage-cache /
batching / filter-cache diagnostics.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.join_serve --tenants 4 \
      --queries-per-tenant 8 --slots 4
  PYTHONPATH=src python -m repro_torch.launch.join_serve --device cpu \
      --trace-out "$TMPDIR/t.json"
  PYTHONPATH=src python -m repro_torch.launch.trace_dump "$TMPDIR/t.json"

  # always-on async tier: event-loop replicas, continuous batching,
  # tenant sharding + work stealing behind one front door
  PYTHONPATH=src python -m repro_torch.launch.join_serve --async --replicas 2

  # crash-safe fault drill: replica0 dies after 2 served steps, and a
  # successor adopts its tenants from its newest checkpoint
  PYTHONPATH=src python -m repro_torch.launch.join_serve --device cpu \
      --async --replicas 2 --checkpoint-dir "$TMPDIR/ckpt" --kill-after 2

  # the mesh: 2 ranks (processes) over gloo on the CPU, the psum merge
  PYTHONPATH=src python -m repro_torch.launch.join_serve --mesh 2 \
      --device cpu --dist-backend gloo --serve-mode psum
  # on the card: one rank a card over NCCL (several ranks on one card
  # need --dist-backend gloo, which carries their tensors through host
  # memory)
  PYTHONPATH=src python -m repro_torch.launch.join_serve --mesh 1

It serves on the CUDA card unless ``--device cpu`` asks for the CPU, and
fails without a card rather than fall back to the CPU.  With ``--mesh N``
it starts N ranks (``launch/mesh.run_ranks``): rank 0 serves the tenants'
queries as mesh classes, the others run the server's worker loop.
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.core.budget import QueryBudget
from repro_torch.core.cost import CostModel, sync
from repro_torch.data.synthetic import overlapping_relations
from repro_torch.launch.mesh import backend_for, run_ranks
from repro_torch.runtime.async_serve import AsyncJoinFrontDoor
from repro_torch.runtime.join_serve import (JoinRequest, JoinServer,
                                            serve_mesh_worker)
from repro_torch.runtime.telemetry import (Tracer, dump_chrome_trace,
                                           format_reconciliation,
                                           reconciliation_report)


def _check_device(device: str) -> str:
    """The device's name for the report; raises without a card unless the
    caller asked for the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("join_serve: no CUDA card; pass --device cpu to "
                           "serve on the CPU")
    return torch.cuda.get_device_name(torch.device(device))


def run(*, tenants: int = 4, queries_per_tenant: int = 8, slots: int = 4,
        base_n: int = 1 << 12, seed: int = 0, device: str = "cuda",
        trace_out: str | None = None, mesh=None,
        serve_mode: str = "exact-parity") -> dict:
    """Serve the tenants' workload: on the kernel route, or with ``mesh``
    (on its rank 0) as mesh classes merged by ``serve_mode``."""
    where = _check_device(device)
    tracer = Tracer(enabled=True) if trace_out else None
    server = JoinServer(batch_slots=slots,
                        cost_model=CostModel(beta_compute=1e-7, epsilon=1e-3),
                        mesh=mesh, serve_mode=serve_mode, tracer=tracer)
    budgets = [QueryBudget(error=0.5), QueryBudget(latency_s=0.5),
               QueryBudget()]
    for t in range(tenants):
        n = base_n << (t % 2)          # two capacity shape classes
        rels = overlapping_relations([n, n], 0.1, seed=seed + t,
                                     device=device)
        server.register_dataset(f"tenant{t}", rels)

    reqs = []
    for q in range(queries_per_tenant):
        for t in range(tenants):       # interleave tenants (worst case)
            reqs.append(server.submit(JoinRequest(
                dataset=f"tenant{t}", budget=budgets[t % len(budgets)],
                query_id=f"tenant{t}/agg", seed=seed + q,
                max_strata=2048, b_max=512, use_kernels=mesh is None)))
    t0 = time.perf_counter()
    server.run()
    sync(device)
    dt = time.perf_counter() - t0

    d = server.diagnostics
    qps = d.queries / max(dt, 1e-9)
    if mesh is not None:
        where = f"mesh[{server.mesh_k}] {dist.get_backend()} on {where}"
    print(f"[join-serve] {d.queries} queries from {tenants} tenants in "
          f"{dt:.2f}s ({qps:.1f} q/s) on {where}")
    print(f"  steps={d.steps} max_batch={d.max_batch} "
          f"compiles={d.compiles} cache_hits={d.cache_hits}")
    print(f"  exact={d.exact_queries} sampled={d.sampled_queries} "
          f"mean_queue_latency={d.queue_latency_s / max(d.queries, 1):.3f}s")
    print(f"  filter_builds={d.filter_builds} "
          f"filter_cache_hits={d.filter_cache_hits} "
          f"shuffled_bytes_saved={d.shuffled_bytes_saved:.0f}")
    if mesh is not None:
        per_dev = [f"{b:.0f}" for b in d.per_device_shuffled_bytes]
        print(f"  dist_shuffled_tuple_bytes={d.dist_shuffled_tuple_bytes:.0f}"
              f" per_device={per_dev}")
        print(f"  serve_mode={serve_mode} "
              f"wire_bytes_model={d.dist_wire_bytes_model:.0f} "
              f"dropped_tuples={d.dist_dropped_tuples:.0f}")
    for r in reqs[:3]:
        print(f"  {r.query_id}: estimate={float(r.result.estimate):.1f} "
              f"+-{float(r.result.error_bound):.1f} "
              f"sampled={bool(r.result.diagnostics.sampled)}")
    if trace_out:
        recon = server.reconciliation_report()
        n_ev = dump_chrome_trace(tracer, trace_out, reconciliation=recon)
        print(f"  trace: {n_ev} events -> {trace_out} (open in "
              "ui.perfetto.dev or chrome://tracing)")
        print(format_reconciliation(recon))
    server.shutdown()
    return {"queries": d.queries, "seconds": dt, "qps": qps, "device": where,
            **d.snapshot()}


def _mesh_rank(mesh, device, kw: dict):
    if dist.get_rank() != 0:
        return serve_mesh_worker(mesh, device)
    return run(mesh=mesh, device=str(device), **kw)


def run_mesh(n: int, *, device: str = "cuda",
             dist_backend: str | None = None, **kw) -> dict:
    """:func:`run` on a mesh of ``n`` ranks over ``dist_backend`` (NCCL on
    the card unless ``'gloo'`` is asked for, gloo on the CPU); returns rank
    0's report.  Without a card it fails before it starts a rank, unless
    ``device`` is the CPU."""
    _check_device(device)
    backend = backend_for(device, dist_backend)
    return run_ranks(_mesh_rank, n, (kw,), backend=backend,
                     device=device, timeout_s=600)[0]


def run_async(*, tenants: int = 4, queries_per_tenant: int = 8,
              slots: int = 4, base_n: int = 1 << 12, seed: int = 0,
              replicas: int = 2, device: str = "cuda",
              checkpoint_dir: str | None = None, kill_after: int = 0,
              trace_out: str | None = None) -> dict:
    """The same tenant workload through the always-on async tier: replica
    event loops with continuous batching behind a work-stealing front door
    (``runtime/async_serve.py``); submissions return futures immediately.

    ``checkpoint_dir`` turns on per-replica engine checkpointing;
    ``kill_after`` N > 0 additionally runs the fault drill: replica0 dies
    (``InjectedFault``) after N served steps, the front door fails it over,
    and a successor adopts its tenants from the newest checkpoint.  Futures
    that were in flight on the dead replica fail with the injected fault
    (counted below); their requests are re-served from the checkpoint by
    the successor."""
    where = _check_device(device)

    def factory(i: int) -> JoinServer:
        return JoinServer(batch_slots=slots,
                          cost_model=CostModel(beta_compute=1e-7,
                                               epsilon=1e-3))

    budgets = [QueryBudget(error=0.5), QueryBudget(latency_s=0.5),
               QueryBudget()]
    tracer = Tracer(enabled=True) if trace_out else None
    with AsyncJoinFrontDoor(replicas=replicas, engine_factory=factory,
                            checkpoint_dir=checkpoint_dir, tracer=tracer,
                            device=device) as fd:
        for t in range(tenants):
            n = base_n << (t % 2)      # two capacity shape classes
            rels = overlapping_relations([n, n], 0.1, seed=seed + t,
                                         device=device)
            fd.register_dataset(f"tenant{t}", rels)
        t0 = time.perf_counter()
        if kill_after:
            # arm before submitting: the drill must fire mid-workload, not
            # race a drained queue (work stealing can empty replica0 fast)
            fd.replicas[0].kill_after(kill_after)
        futs = []
        for q in range(queries_per_tenant):
            for t in range(tenants):   # interleave tenants (worst case)
                futs.append(fd.submit(JoinRequest(
                    dataset=f"tenant{t}", budget=budgets[t % len(budgets)],
                    query_id=f"tenant{t}/agg", seed=seed + q,
                    max_strata=2048, b_max=512, use_kernels=True)))
        reqs, killed = [], 0
        for f in futs:
            try:
                reqs.append(f.result(timeout=600))
            except BaseException:  # noqa: BLE001 (the injected fault)
                killed += 1
        if kill_after:
            fd.maybe_failover()
            # re-served-from-checkpoint requests carry no caller futures:
            # wait for the successor to drain its adopted queue
            deadline = time.monotonic() + 600
            while any(r.backlog() for r in fd.replicas
                      if r.error is None) and time.monotonic() < deadline:
                time.sleep(0.01)
        sync(device)
        dt = time.perf_counter() - t0
        snap = fd.snapshot()

    qps = len(reqs) / max(dt, 1e-9)
    # the live replicas' count: a successor's restored counters carry the
    # queries the dead replica served before its last checkpoint
    served = sum(rd["queries"] for name, rd in snap["replicas"].items()
                 if name not in snap["failed"])
    print(f"[join-serve --async] {len(reqs)} queries from {tenants} tenants "
          f"in {dt:.2f}s ({qps:.1f} q/s) on {where} x{replicas} replicas "
          f"steals={snap['steals']}")
    if kill_after:
        print(f"  fault drill: killed replica0 after {kill_after} steps; "
              f"failovers={snap['failovers']} futures_failed={killed} "
              f"(re-served from checkpoint by the successor); live fleet "
              f"queries={served} = {len(reqs)} returned + {killed} failed")
    for name, rd in snap["replicas"].items():
        print(f"  {name}: queries={rd['queries']} steps={rd['steps']} "
              f"max_batch={rd['max_batch']} backfilled={rd['backfilled']} "
              f"stolen_in={rd['stolen_in']} "
              f"checkpoints={rd['checkpoints']} "
              f"queue_p95={rd['queue_latency_p95_s']:.3f}s "
              f"e2e_p95={rd['e2e_latency_p95_s']:.3f}s")
    for r in reqs[:3]:
        print(f"  {r.query_id}: estimate={float(r.result.estimate):.1f} "
              f"+-{float(r.result.error_bound):.1f} "
              f"sampled={bool(r.result.diagnostics.sampled)}")
    if trace_out:
        # fleet-level report: the shared tracer holds every replica's
        # per-query recon records; server-level byte pairs are per-engine,
        # so the fleet dump aggregates queries only
        recon = reconciliation_report(tracer.recon)
        n_ev = dump_chrome_trace(tracer, trace_out, reconciliation=recon)
        print(f"  trace: {n_ev} events -> {trace_out} (open in "
              "ui.perfetto.dev or chrome://tracing)")
        print(format_reconciliation(recon))
    return {"queries": len(reqs), "futures_failed": killed,
            "replica_queries": served, "seconds": dt, "qps": qps,
            "device": where, **snap}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--queries-per-tenant", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--base-n", type=int, default=1 << 12)
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record per-query span trees and write a Chrome "
                         "trace-event JSON (perfetto-viewable) plus a "
                         "modeled-vs-measured byte reconciliation report; "
                         "summarize with repro_torch.launch.trace_dump")
    ap.add_argument("--mesh", type=int, default=0,
                    help="serve over N ranks, one process each (0 = off)")
    ap.add_argument("--serve-mode", default="exact-parity",
                    choices=["exact-parity", "psum"],
                    help="mesh merge: bit-parity gather or the psum of "
                         "estimator parts over capacity-planned buckets")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="the mesh's backend (default: nccl on the card, "
                         "gloo on the CPU; gloo on the card carries the "
                         "tensors through host memory)")
    ap.add_argument("--async", dest="async_", action="store_true",
                    help="serve through the async tier (event-loop "
                         "replicas + front door) instead of the step loop")
    ap.add_argument("--replicas", type=int, default=2,
                    help="front-door replica event loops (with --async)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="per-replica engine checkpointing directory "
                         "(with --async): crash-safe serving state")
    ap.add_argument("--kill-after", type=int, default=0,
                    help="fault drill (with --async + --checkpoint-dir): "
                         "kill replica0 after N served steps and fail its "
                         "tenants over to a successor")
    args = ap.parse_args()
    if args.kill_after and not (args.async_ and args.checkpoint_dir):
        ap.error("--kill-after needs --async and --checkpoint-dir")
    common = dict(tenants=args.tenants,
                  queries_per_tenant=args.queries_per_tenant,
                  slots=args.slots, base_n=args.base_n, device=args.device,
                  trace_out=args.trace_out)
    if args.mesh and args.async_:
        ap.error("--mesh serves through the step loop, not --async")
    if args.async_:
        run_async(replicas=args.replicas, checkpoint_dir=args.checkpoint_dir,
                  kill_after=args.kill_after, **common)
    elif args.mesh:
        device = common.pop("device")
        run_mesh(args.mesh, device=device, dist_backend=args.dist_backend,
                 serve_mode=args.serve_mode, **common)
    else:
        run(**common)


if __name__ == "__main__":
    main()
