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

  # distributed: every window a mesh class over 2 ranks (processes), gloo
  # on the CPU; on the card --mesh 1 (NCCL), or --dist-backend gloo for
  # several ranks sharing one card
  PYTHONPATH=src python -m repro_torch.launch.join_stream --mesh 2 \
      --device cpu --dist-backend gloo --serve-mode psum

It serves on the CUDA card unless ``--device cpu`` asks for the CPU, and
fails without a card rather than fall back to the CPU.  With ``--mesh N``
it starts N ranks (``launch/mesh.run_on_mesh``): rank 0 streams, its windows
served as mesh classes merged by ``--serve-mode``, and the others run the
server's worker loop.
"""

from __future__ import annotations

import argparse
import time

import torch.distributed as dist

from repro_torch.core.budget import QueryBudget
from repro_torch.core.cost import CostModel, sync
from repro_torch.core.window import WindowSpec
from repro_torch.data.synthetic import overlapping_relations
from repro_torch.launch.mesh import check_device, run_on_mesh
from repro_torch.runtime.stream_join import StreamJoinServer


def run(*, tenants: int = 2, pushes: int = 12, size: int = 4, slide: int = 1,
        sub_rows: int = 2048, seed: int = 0, window_slots: int = 8,
        device: str = "cuda", mesh=None,
        serve_mode: str = "exact-parity") -> dict:
    """Stream the tenants' sessions: every window on the kernel route, or
    with ``mesh`` (on its rank 0) as mesh classes merged by
    ``serve_mode``."""
    where = check_device(device, "join_stream")
    server = StreamJoinServer(batch_slots=max(tenants, 1),
                              window_slots=window_slots,
                              cost_model=CostModel(beta_compute=1e-7,
                                                   epsilon=1e-3),
                              mesh=mesh, serve_mode=serve_mode)
    budgets = [QueryBudget(error=0.5), QueryBudget(latency_s=0.5)]
    sessions = [server.open_stream(
        f"tenant{t}", WindowSpec(size, slide, sub_rows),
        budget=budgets[t % len(budgets)], max_strata=2048, b_max=512,
        seed=seed + t, use_kernels=mesh is None) for t in range(tenants)]

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
    if mesh is not None:
        where = f"mesh[{server.mesh_k}] {dist.get_backend()} on {where} " \
            f"({serve_mode})"
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
    if mesh is not None:
        print(f"  dist_shuffled_tuple_bytes={d.dist_shuffled_tuple_bytes:.0f}"
              f" dropped_tuples={d.dist_dropped_tuples:.0f} "
              f"window scatter model="
              f"{sessions[0].window_scatter_bytes_model():.0f} B a window")
        server.shutdown()
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
    ap.add_argument("--mesh", type=int, default=0,
                    help="serve the windows over N ranks, one process each "
                         "(0 = off)")
    ap.add_argument("--serve-mode", default="exact-parity",
                    choices=["exact-parity", "psum"],
                    help="mesh merge: bit-parity gather or the psum of "
                         "estimator parts over buckets planned from the "
                         "windows' rolling overlap")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="the mesh's backend (default: nccl on the card, "
                         "gloo on the CPU; gloo on the card carries the "
                         "tensors through host memory)")
    args = ap.parse_args()
    kw = dict(tenants=args.tenants, pushes=args.pushes, size=args.size,
              slide=args.slide, sub_rows=args.sub_rows,
              window_slots=args.window_slots)
    if args.mesh:
        run_on_mesh(run, args.mesh, dict(serve_mode=args.serve_mode, **kw),
                    device=args.device, dist_backend=args.dist_backend,
                    who="join_stream")
    else:
        run(device=args.device, **kw)


if __name__ == "__main__":
    main()
