"""StreamJoin driver: windowed streaming ApproxJoin over synthetic streams.

Opens one streaming session per tenant (mixed error- and latency-budget,
every window on the kernel route), feeds per-tenant micro-batch streams made
on the device, serves every window that becomes due and prints per-window
estimates plus the streaming/serving diagnostics (incremental filter reuse,
admission shedding, queue-latency percentiles, running whole-stream
estimate).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.join_stream --size 4 \
      --slide 1 --sub-rows 2048 --pushes 12
  PYTHONPATH=src python -m repro_torch.launch.join_stream --device cpu

It serves on the CUDA card unless ``--device cpu`` asks for the CPU, and
fails without a card rather than fall back to the CPU.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.budget import QueryBudget
from repro_torch.core.cost import CostModel, sync
from repro_torch.core.window import WindowSpec
from repro_torch.data.synthetic import overlapping_relations
from repro_torch.runtime.stream_join import StreamJoinServer


def run(*, tenants: int = 2, pushes: int = 12, size: int = 4, slide: int = 1,
        sub_rows: int = 2048, seed: int = 0, window_slots: int = 8,
        device: str = "cuda") -> dict:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("join_stream: no CUDA card; pass --device cpu to "
                           "stream on the CPU")
    server = StreamJoinServer(batch_slots=max(tenants, 1),
                              window_slots=window_slots,
                              cost_model=CostModel(beta_compute=1e-7,
                                                   epsilon=1e-3))
    budgets = [QueryBudget(error=0.5), QueryBudget(latency_s=0.5)]
    sessions = [server.open_stream(
        f"tenant{t}", WindowSpec(size, slide, sub_rows),
        budget=budgets[t % len(budgets)], max_strata=2048, b_max=512,
        seed=seed + t, use_kernels=True) for t in range(tenants)]

    t0 = time.perf_counter()
    for i in range(pushes):
        for t, sess in enumerate(sessions):
            sess.push(overlapping_relations(
                [sub_rows] * 2, 0.1, seed=seed + 1000 * (t + 1) + i,
                device=device))
        server.run()
    sync(device)
    dt = time.perf_counter() - t0

    d = server.diagnostics
    s = server.stream_diagnostics
    where = torch.cuda.get_device_name(torch.device(device)) \
        if torch.device(device).type == "cuda" else "cpu"
    print(f"[join-stream] {s.sub_windows} micro-batches -> "
          f"{s.windows_emitted} windows from {tenants} tenants in {dt:.2f}s "
          f"on {where}")
    print(f"  filter_builds={d.filter_builds} "
          f"filter_cache_hits={d.filter_cache_hits} "
          f"retired={s.retired_filter_words} shed={s.windows_shed}")
    snap = d.snapshot()
    print(f"  compiles={d.compiles} cache_hits={d.cache_hits} "
          f"queue_latency p50/p95/max = "
          f"{snap['queue_latency_p50_s']:.3f}/"
          f"{snap['queue_latency_p95_s']:.3f}/"
          f"{snap['queue_latency_max_s']:.3f} s")
    for sess in sessions:
        done = sess.drain()
        for r in done[-2:]:
            print(f"  {sess.name} w{r.window_id}: "
                  f"estimate={float(r.result.estimate):.1f} "
                  f"+-{float(r.result.error_bound):.1f} "
                  f"sampled={bool(r.result.diagnostics.sampled)}")
        running = sess.running_estimate()
        if running is not None:
            print(f"  {sess.name} running ({sess.accumulated_windows} "
                  f"disjoint windows): {float(running.estimate):.1f} "
                  f"+-{float(running.error_bound):.1f}")
    return {"windows": s.windows_emitted, "seconds": dt, "device": where,
            **d.snapshot(), **s.snapshot()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--pushes", type=int, default=12)
    ap.add_argument("--size", type=int, default=4,
                    help="sub-windows per window")
    ap.add_argument("--slide", type=int, default=1,
                    help="sub-windows per emission (== size: tumbling)")
    ap.add_argument("--sub-rows", type=int, default=1 << 11)
    ap.add_argument("--window-slots", type=int, default=8,
                    help="max queued windows per tenant before shedding")
    ap.add_argument("--device", default="cuda",
                    help="device to stream on (default the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args()
    run(tenants=args.tenants, pushes=args.pushes, size=args.size,
        slide=args.slide, sub_rows=args.sub_rows,
        window_slots=args.window_slots, device=args.device)


if __name__ == "__main__":
    main()
