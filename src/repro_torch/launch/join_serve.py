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

It serves on the CUDA card unless ``--device cpu`` asks for the CPU, and
fails without a card rather than fall back to the CPU.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.budget import QueryBudget
from repro_torch.core.cost import CostModel, sync
from repro_torch.data.synthetic import overlapping_relations
from repro_torch.runtime.join_serve import JoinRequest, JoinServer
from repro_torch.runtime.telemetry import (Tracer, dump_chrome_trace,
                                           format_reconciliation)


def run(*, tenants: int = 4, queries_per_tenant: int = 8, slots: int = 4,
        base_n: int = 1 << 12, seed: int = 0, device: str = "cuda",
        trace_out: str | None = None) -> dict:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("join_serve: no CUDA card; pass --device cpu to "
                           "serve on the CPU")
    tracer = Tracer(enabled=True) if trace_out else None
    server = JoinServer(batch_slots=slots,
                        cost_model=CostModel(beta_compute=1e-7, epsilon=1e-3),
                        tracer=tracer)
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
                max_strata=2048, b_max=512, use_kernels=True)))
    t0 = time.perf_counter()
    server.run()
    sync(device)
    dt = time.perf_counter() - t0

    d = server.diagnostics
    qps = d.queries / max(dt, 1e-9)
    where = torch.cuda.get_device_name(torch.device(device)) \
        if torch.device(device).type == "cuda" else "cpu"
    print(f"[join-serve] {d.queries} queries from {tenants} tenants in "
          f"{dt:.2f}s ({qps:.1f} q/s) on {where}")
    print(f"  steps={d.steps} max_batch={d.max_batch} "
          f"compiles={d.compiles} cache_hits={d.cache_hits}")
    print(f"  exact={d.exact_queries} sampled={d.sampled_queries} "
          f"mean_queue_latency={d.queue_latency_s / max(d.queries, 1):.3f}s")
    print(f"  filter_builds={d.filter_builds} "
          f"filter_cache_hits={d.filter_cache_hits} "
          f"shuffled_bytes_saved={d.shuffled_bytes_saved:.0f}")
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
    return {"queries": d.queries, "seconds": dt, "qps": qps, "device": where,
            **d.snapshot()}


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
    args = ap.parse_args()
    run(tenants=args.tenants, queries_per_tenant=args.queries_per_tenant,
        slots=args.slots, base_n=args.base_n, device=args.device,
        trace_out=args.trace_out)


if __name__ == "__main__":
    main()
