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

  # the async fleet on a mesh: both replicas mesh servers over the same
  # 2 ranks, and its fault drill (the successor restores onto the mesh)
  PYTHONPATH=src python -m repro_torch.launch.join_serve --device cpu \
      --async --mesh 2 --dist-backend gloo \
      --checkpoint-dir "$TMPDIR/ckpt" --kill-after 2

It serves on the CUDA card unless ``--device cpu`` asks for the CPU, and
fails without a card rather than fall back to the CPU.  With ``--mesh N``
it starts N ranks (``launch/mesh.run_on_mesh``): rank 0 serves the tenants'
queries as mesh classes (through the async fleet with ``--async``, every
replica a mesh server over the same ranks), the others run the servers'
worker loop.
"""

from __future__ import annotations

import argparse
import time

import torch.distributed as dist

from repro_torch.core.budget import QueryBudget
from repro_torch.core.cost import CostModel, sync
from repro_torch.data.synthetic import overlapping_relations
from repro_torch.launch.mesh import check_device, run_on_mesh
from repro_torch.runtime.async_serve import AsyncJoinFrontDoor
from repro_torch.runtime.join_serve import JoinRequest, JoinServer
from repro_torch.runtime.telemetry import (Tracer, dump_chrome_trace,
                                           format_reconciliation,
                                           reconciliation_report)


def run(*, tenants: int = 4, queries_per_tenant: int = 8, slots: int = 4,
        base_n: int = 1 << 12, seed: int = 0, device: str = "cuda",
        trace_out: str | None = None, mesh=None,
        serve_mode: str = "exact-parity") -> dict:
    """Serve the tenants' workload: on the kernel route, or with ``mesh``
    (on its rank 0) as mesh classes merged by ``serve_mode``."""
    where = check_device(device, "join_serve")
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


def run_async(*, tenants: int = 4, queries_per_tenant: int = 8,
              slots: int = 4, base_n: int = 1 << 12, seed: int = 0,
              replicas: int = 2, device: str = "cuda",
              checkpoint_dir: str | None = None, kill_after: int = 0,
              trace_out: str | None = None, mesh=None,
              serve_mode: str = "exact-parity") -> dict:
    """The same tenant workload through the always-on async tier: replica
    event loops with continuous batching behind a work-stealing front door
    (``runtime/async_serve.py``); submissions return futures immediately.

    ``checkpoint_dir`` turns on per-replica engine checkpointing;
    ``kill_after`` N > 0 additionally runs the fault drill: replica0 dies
    (``InjectedFault``) after N served steps, the front door fails it over,
    and a successor adopts its tenants from the newest checkpoint.  Futures
    that were in flight on the dead replica fail with the injected fault
    (counted below); their requests are re-served from the checkpoint by
    the successor.  With ``mesh`` (on its rank 0) every replica is a mesh
    server over its ranks, serving the queries as mesh classes merged by
    ``serve_mode``, and the successor restores onto the mesh."""
    where = check_device(device, "join_serve")

    def factory(i: int) -> JoinServer:
        return JoinServer(batch_slots=slots,
                          cost_model=CostModel(beta_compute=1e-7,
                                               epsilon=1e-3),
                          mesh=mesh, serve_mode=serve_mode)

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
            # arm before submitting, and steal nothing until the failover:
            # the first submission routes to replica0, which then keeps its
            # tenant's queries (a repeat of a query id waits for the next
            # step) and dies at its Nth step whatever the timing, given
            # --queries-per-tenant >= N
            fd.replicas[0].kill_after(kill_after)
            fd.work_stealing = False
        futs = []
        for q in range(queries_per_tenant):
            for t in range(tenants):   # interleave tenants (worst case)
                futs.append(fd.submit(JoinRequest(
                    dataset=f"tenant{t}", budget=budgets[t % len(budgets)],
                    query_id=f"tenant{t}/agg", seed=seed + q,
                    max_strata=2048, b_max=512, use_kernels=mesh is None)))
        reqs, killed = [], 0
        for f in futs:
            try:
                reqs.append(f.result(timeout=600))
            except BaseException:  # noqa: BLE001 (the injected fault)
                killed += 1
        if kill_after:
            fd.maybe_failover()
            fd.work_stealing = True
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
    if mesh is not None:
        where = f"mesh[{fd.replicas[0].engine.mesh_k}] " \
            f"{dist.get_backend()} on {where}"
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
    fleet = dict(replicas=args.replicas, checkpoint_dir=args.checkpoint_dir,
                 kill_after=args.kill_after) if args.async_ else {}
    if args.mesh:
        device = common.pop("device")
        run_on_mesh(run_async if args.async_ else run, args.mesh,
                    dict(serve_mode=args.serve_mode, **common, **fleet),
                    device=device, dist_backend=args.dist_backend,
                    who="join_serve")
    elif args.async_:
        run_async(**fleet, **common)
    else:
        run(**common)


if __name__ == "__main__":
    main()
