"""Dry run of the paper's own operator at production scale, one rank's
program.

The distributed ApproxJoin (filter -> shuffle -> sample -> estimate,
``core/distributed.make_distributed_join``, the paper's partial-aggregate
merge) runs as rank 0 of the full 256- or 512-rank mesh over a fake
process group (``launch/mesh.fake_ranks``: its collectives move nothing),
on that rank's block of rows, made from ``--seed``.  It reports the three
roofline terms on the H100's rates (``launch/roofline.py``) and the
collective census: the check, at cluster scale, of the paper's Eq. 24
communication claims.

Unlike the model cells (``launch/dryrun.py``, ``meta`` tensors) the join
needs real rows: its shapes are static but its steps read data (sample
sizes, strata).  It runs on the card by default, where the filter build,
the probe and the sampler are the three CUDA kernels; ``--device cpu``
runs their plain versions.  The census does not depend on the device.
With ``--reps N`` each variant also runs N times unmetered
(``measured_s``, the median) beside its roofline floor.  ``--mesh DxM``
replaces the production mesh by a ``(data, model)`` one.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_join [--multi-pod]
      [--log2-rows 26] [--device cuda|cpu] [--seed 0] [--mesh 1x1]
      [--reps 3]
      [--out experiments/dryrun_join_torch.json]
"""

from __future__ import annotations

import argparse
import json
import os

import torch.distributed as dist

from repro_torch.core import bloom
from repro_torch.core.distributed import (make_distributed_join,
                                          planned_bucket_cap)
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (check_device, fake_ranks,
                                     make_host_mesh, make_production_mesh)

KERNELS = ("bloom_build", "bloom_probe", "edge_sample")


def kernel_wrappers() -> dict:
    """The three kernels' wrappers, whose ``launches`` count their
    launches."""
    from repro_torch.kernels import bloom_build, bloom_probe, edge_sample
    return {"bloom_build": bloom_build.bloom_build_batched,
            "bloom_probe": bloom_probe.bloom_probe_batched,
            "edge_sample": edge_sample.edge_sample_batched}


def rank_rows(local: int, seed: int, device):
    """This rank's block of the two relations: ``local`` rows each, 1% of
    them on keys the relations share (the overlap the cap-planned cell
    plans for)."""
    from repro_torch.data.synthetic import overlapping_relations
    return overlapping_relations([local, local], overlap_fraction=0.01,
                                 keys_per_dataset=1 << 16, seed=seed,
                                 device=device)


def run_join_cell(mesh, rels, *, log2_rows: int, mode: str,
                  filter_stage: bool, sample_fraction: float = 0.1,
                  fp_rate: float = 0.01, overlap_hint: float = 1.0,
                  verbose: bool = True, reps: int = 0) -> dict:
    """One variant's record.  ``rels`` is this rank's block of the two
    relations (``2^log2_rows / chips`` rows each).  ``overlap_hint`` < 1
    sizes the shuffle buckets from the filter's live-fraction estimate
    (``planned_bucket_cap``, as the JoinServer's psum mode does) instead
    of the whole input: with static shapes that is how the filter's saving
    reaches the wire.  ``reps`` > 0 also times the variant, unmetered
    (``measured_s``, the median of ``reps`` runs)."""
    axes = tuple(mesh.mesh_dim_names)          # the join uses every axis
    chips = int(mesh.size())
    n_global = 1 << log2_rows
    local = n_global // chips
    if rels[0].capacity != local:
        raise ValueError(f"{rels[0].capacity} rows a rank, want {local}")
    bucket_cap = planned_bucket_cap(local, chips, overlap_hint, floor=16)
    max_strata = min(chips * bucket_cap, 1 << 16)
    num_blocks = bloom.num_blocks_for(local, fp_rate)  # a shard's filter
    run = make_distributed_join(
        mesh, n_rels=2, join_axes=axes, mode=mode,
        filter_stage=filter_stage, sample_fraction=sample_fraction,
        bucket_cap=bucket_cap, max_strata=max_strata, b_max=512,
        num_blocks=num_blocks, merge="psum", use_kernels=True)
    dev = rels[0].keys.device
    wrappers = kernel_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    with RL.Meters(dev) as meters:
        run(list(rels), 0.0)
    launches = {k: w.launches - before[k] for k, w in wrappers.items()}
    roof = RL.analyze(meters, chips=chips, model_flops=0.0)
    measured = {}
    if reps:
        measured["measured_s"] = RL.timed(lambda: run(list(rels), 0.0), dev,
                                          reps)
    rec = {
        "operator": f"approxjoin[{mode}"
                    f"{'' if filter_stage else ',nofilter'}]",
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "chips": chips,
        "rows_per_relation": n_global,
        "bloom_blocks_per_shard": num_blocks,
        "bucket_cap": bucket_cap,
        "compute_s": roof.compute_s, "memory_s": roof.memory_s,
        "collective_s": roof.collective_s, "dominant": roof.dominant,
        "flops_per_device": roof.flops,
        "hbm_bytes_per_device": roof.hbm_bytes,
        "coll_bytes_per_device": roof.coll_bytes,
        "nvlink_bytes_per_device": roof.nvlink_bytes,
        "network_bytes_per_device": roof.network_bytes,
        "collective_ops": roof.collectives,
        "census": meters.census,
        "kernel_bytes": meters.kernel_bytes,
        "launches": launches,
        "peak_bytes": meters.peak_bytes, "peak_from": meters.peak_from,
        "device": str(dev),
        **measured,
    }
    if verbose:
        print(f"  {rec['operator']:28s} chips={chips} "
              f"terms=({roof.compute_s:.2e},{roof.memory_s:.2e},"
              f"{roof.collective_s:.2e})s dominant={roof.dominant} "
              f"colls={roof.collectives} launches={launches}"
              + (roof.against(measured["measured_s"]) if measured else ""),
              flush=True)
    return rec


def run_variants(mesh, rels, log2_rows: int, verbose: bool = True,
                 reps: int = 0) -> list:
    """The JAX package's four records: exact, exact without the filter,
    sample, and sample with buckets planned at a 1% overlap."""
    records = [run_join_cell(mesh, rels, log2_rows=log2_rows, mode=mode,
                             filter_stage=filt, verbose=verbose, reps=reps)
               for mode, filt in (("exact", True), ("exact", False),
                                  ("sample", True))]
    rec = run_join_cell(mesh, rels, log2_rows=log2_rows, mode="sample",
                        filter_stage=True, overlap_hint=0.01,
                        verbose=verbose, reps=reps)
    rec["operator"] = "approxjoin[sample,cap-planned]"
    records.append(rec)
    return records


def planned_ratio(records: list) -> float:
    """Collective bytes of the naive-capacity sample over the cap-planned
    one."""
    planned, unplanned = records[3], records[2]
    return unplanned["coll_bytes_per_device"] / max(
        planned["coll_bytes_per_device"], 1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--log2-rows", type=int, default=26)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None,
                    help="a (data, model) mesh in place of the production "
                         "one, e.g. 1x1")
    ap.add_argument("--reps", type=int, default=0,
                    help="time each variant over this many unmetered runs")
    ap.add_argument("--out", default="experiments/dryrun_join_torch.json")
    args = ap.parse_args(argv)
    name = check_device(args.device, "dryrun_join")
    shape = tuple(int(n) for n in args.mesh.split("x")) if args.mesh \
        else None
    world = shape[0] * shape[1] if shape else 512 if args.multi_pod else 256
    with fake_ranks(world):
        mesh = make_host_mesh(*shape) if shape \
            else make_production_mesh(multi_pod=args.multi_pod)
        local = (1 << args.log2_rows) // world
        rels = rank_rows(local, args.seed, args.device)
        print(f"== join dry-run on mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"({dist.get_world_size()} fake ranks; rank 0's {local} rows "
              f"a relation on {name}) ==", flush=True)
        records = run_variants(mesh, rels, args.log2_rows, reps=args.reps)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(records, fh, indent=1)
    # the paper's headline at the census: with static shapes the saving
    # only reaches the wire once capacities are planned from the filter's
    # overlap estimate
    print(f"collective bytes, naive-capacity / filter-planned-capacity = "
          f"{planned_ratio(records):.1f}x at 1% overlap")


if __name__ == "__main__":
    main()
