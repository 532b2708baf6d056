"""Dry run of the model stack at production scale, one rank's program.

For every (arch x applicable input shape x mesh) cell: the model at full
width and depth on the ``meta`` device (shapes, no memory), cut to rank 0's
shards of the production mesh (``shard_params``) under the config's
logical-axis rules, over a fake process group of 256 or 512 ranks
(``launch/mesh.fake_ranks``: its collectives move nothing); then the cell's
step on a data rank's rows, metered (``launch/roofline.Meters``): one train
step (``make_train_step``, AdamW included), the prefill forward, or one
``decode_step`` on the cache ``shard_cache`` cut.  The record holds its
memory, its roofline on the H100's rates and the collective census.

``meta`` tensors are the counterpart of the JAX package's
``ShapeDtypeStruct``\\ s: they carry shapes and dtypes through every op and
allocate nothing, which is what lets one process play a rank of a 16B
model.  That is the design of a dry run, not a fallback from the card.  The
same cell runs for real on the card (``--device cuda``) where it fits:
then the peak is the card allocator's, and ``measured_s`` the median wall
time of the step, unmetered, beside its roofline floor; ``chip_smoke.py``
holds the meters against the card so (``--mesh 1x1``, a cut depth).

Memory (bytes of rank 0): ``argument_bytes`` the step's inputs (parameters,
and for train AdamW's moments; the batch; the decode cache),
``output_bytes`` its outputs, ``temp_bytes`` the most bytes alive at once
of the storages the step made (``Meters.peak_bytes``), ``peak_bytes`` the
two together.

Meshes: single-pod ``(16, 16)`` ``("data", "model")`` and multi-pod ``(2,
16, 16)`` ``("pod", "data", "model")``.  ``--rule`` overrides a logical
rule, ``--set`` a config field; ``--mesh DxM`` replaces the production
mesh by a ``(data, model)`` one, ``--batch`` and ``--seq`` the shape's
global batch and length.  ``--zero1`` cuts a train cell's AdamW slots over
``data`` as well (``ZERO1_RULES``: ``make_train_step(zero1=True)``); its
records say ``"zero1": true`` and their files end in ``_zero1``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k [--multi-pod | --both-meshes] [--rule seq=model] \\
      [--set moe_impl=ep] [--zero1] [--out experiments/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cuda \
      --mesh 1x1 --arch qwen3-1.7b --set n_layers=2 --shape train_4k \
      --batch 2 --seq 4096
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, applicable
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (check_device, fake_ranks,
                                     make_host_mesh, make_production_mesh)
from repro_torch.models import Model
from repro_torch.models.model import CLIP_DIM
from repro_torch.runtime.train import make_train_step, train_state_init
from repro_torch.sharding.specs import (DEFAULT_RULES, bound_axis,
                                        local_shape, logical_rules, rebind,
                                        shard_cache, shard_params, spec_for)

WORLD = {False: 256, True: 512}


def batch_specs(cfg, kind: str, seq: int, batch: int,
                device="meta") -> dict:
    """Zeros of every model input of this cell, whole (the JAX package's
    ``batch_specs``; on ``meta`` shapes only)."""
    def empty(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    specs = {"tokens": empty((batch, seq), torch.int32)}
    if kind == "train":
        specs["targets"] = empty((batch, seq), torch.int32)
    if cfg.num_img_tokens and kind != "decode":
        specs["img_embeds"] = empty((batch, cfg.num_img_tokens, CLIP_DIM),
                                    torch.float32)
    if cfg.is_encdec and kind != "decode":
        e = cfg.encoder
        specs["frames"] = empty((batch, e.n_frames, e.d_input), torch.float32)
    return specs


def local_rows(specs: dict, mesh) -> dict:
    """A data rank's rows of each input: its batch dim cut as ``spec_for``
    lays ``("batch", ...)`` over the mesh (whole where it does not
    divide)."""
    out = {}
    for k, t in specs.items():
        names = ("batch",) + (None,) * (t.dim() - 1)
        shape = local_shape(spec_for(names, t.shape, mesh, DEFAULT_RULES),
                            t.shape, mesh)
        out[k] = torch.zeros(shape, dtype=t.dtype, device=t.device)
    return out


def tensor_bytes(tree) -> int:
    """Bytes of the tensors of a nested tuple / list / dict / NamedTuple."""
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class Cell(NamedTuple):
    """A built cell: the step's arguments (by kind: ``state`` (the
    parameters and AdamW's), ``params``, ``batch``, ``cache``, ``tokens``)
    and ``run()``, which takes the step and returns its outputs, and the
    whole model's parameter counts."""
    args: dict
    run: object
    n_params: int
    n_active: int


def build_cell(cfg, cell, mesh, rules: dict, device="meta",
               zero1: bool = False) -> Cell:
    """The model of ``cell`` (a ``configs.ShapeCell``), cut to rank 0's
    shards, and its step (a train step's AdamW slots cut over ``data`` too
    with ``zero1``); call under ``logical_rules(mesh, rules)``."""
    model = Model(cfg, device=device)
    n_total, n_active = RL.count_params(model, cfg)
    shard_params(model, mesh, rules)
    model.requires_grad_(cell.kind == "train")
    if cell.kind == "train":
        batch = local_rows(batch_specs(cfg, "train", cell.seq, cell.batch,
                                       device), mesh)
        data = bound_axis("data")
        data = None if data is None else data.group
        model_axis = bound_axis("model")
        step = make_train_step(
            model, data_group=data, zero1=zero1,
            model_group=None if model_axis is None else model_axis.group)
        state = train_state_init(model, zero1=zero1, data_group=data)
        return Cell({"state": state, "batch": batch},
                    lambda: step(state, batch), n_total, n_active)
    if cell.kind == "prefill":
        batch = local_rows(batch_specs(cfg, "prefill", cell.seq, cell.batch,
                                       device), mesh)

        def prefill():
            with torch.no_grad():
                return model.forward(batch)[0]
        return Cell({"params": dict(model.named_parameters()),
                     "batch": batch}, prefill, n_total, n_active)
    # decode: the whole cache's shapes, cut to rank 0's shard
    with rebind(None):
        whole = model.cache_shape(cell.batch, cell.seq)
    whole = _materialize(whole, device)
    cache = shard_cache(whole, mesh, rules)
    tokens = local_rows({"tokens": torch.zeros(
        (cell.batch,), dtype=torch.int32, device=device)}, mesh)["tokens"]
    return Cell({"params": dict(model.named_parameters()),
                 "cache": cache, "tokens": tokens},
                lambda: model.decode_step(tokens, cache), n_total, n_active)


def _materialize(cache, device):
    """``cache`` (meta shapes) as empty tensors on ``device``."""
    from repro_torch.sharding.axes import cache_map
    if torch.device(device).type == "meta":
        return cache
    return cache_map(cache, lambda path, t: torch.zeros(
        t.shape, dtype=t.dtype, device=device))


def run_cell(arch: str, shape_name: str, mesh, *, verbose=True,
             rules=None, cfg_overrides=None, device="meta", batch=None,
             seq=None, reps: int = 3, zero1: bool = False) -> dict:
    """One cell's record (the JAX package's keys, ``rules_bound`` and, for
    ``zero1``, ``"zero1": true``):
    ``status`` ok, skipped (with the reason ``configs.applicable`` gives)
    or failed (with the error).  ``batch`` / ``seq`` replace the shape's;
    on a real device the step runs once unmetered, once metered, then
    ``reps`` times timed (``measured_s``)."""
    cfg = ARCHS[arch]
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cell = SHAPES[shape_name]
    cell = cell._replace(batch=batch or cell.batch, seq=seq or cell.seq)
    dev = torch.device(device)
    dims = dict(zip(mesh.mesh_dim_names, mesh.shape))
    chips = int(mesh.size())
    rec = {"arch": arch, "shape": shape_name, "mesh": dims, "chips": chips}
    base = SHAPES[shape_name]
    if (cell.batch, cell.seq) != (base.batch, base.seq):
        rec["batch"], rec["seq"] = cell.batch, cell.seq
    if cfg_overrides:
        rec["cfg_overrides"] = dict(cfg_overrides)
    if rules:
        rec["rules_override"] = dict(rules)
    if zero1:
        rec["zero1"] = True
    ok, why = applicable(cfg, shape_name)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    merged = {**dict(cfg.rules or ()), **(rules or {})}
    rec["rules_bound"] = merged
    t0 = time.time()
    try:
        with logical_rules(mesh, merged):
            built = build_cell(cfg, cell, mesh, merged, dev, zero1)
            real = dev.type != "meta"
            if real:
                built.run()                      # warm: kernels, workspace
            with RL.Meters(dev) as meters:
                out = built.run()
            if real:
                rec["measured_s"] = RL.timed(built.run, dev, reps)
        arg_bytes = tensor_bytes(built.args)
        rec["run_s"] = round(time.time() - t0, 1)
        rec["memory"] = {
            "argument_bytes": arg_bytes,
            "output_bytes": tensor_bytes(out),
            "temp_bytes": meters.peak_bytes,
            "peak_bytes": arg_bytes + meters.peak_bytes,
            "peak_from": meters.peak_from,
        }
        mf = RL.model_flops_for(cfg, built.n_params, built.n_active,
                                cell.kind, cell.batch, cell.seq)
        roof = RL.analyze(meters, chips=chips, model_flops=mf)
        rec["device"] = str(dev)
        rec["roofline"] = {**RL.roofline_record(roof),
                           "census": meters.census,
                           "kernel_bytes": meters.kernel_bytes,
                           "n_params": built.n_params,
                           "n_active": built.n_active}
        if cfg.ff_kind == "moe" and cfg.moe_impl == "ep":
            df, dh = RL.ep_moe_correction(cfg, cell.kind, cell.batch,
                                          cell.seq, chips, dims["model"])
            # kept beside the counts, not added: the flop counter sees the
            # expert-parallel bodies the JAX package's HLO count misses
            rec["ep_correction"] = {"flops_per_device": df,
                                    "hbm_bytes_per_device": dh,
                                    "added": False}
        rec["status"] = "ok"
        if verbose:
            print(f"  OK   {arch:24s} {shape_name:12s} "
                  f"{'x'.join(map(str, mesh.shape))} on {dev.type}  "
                  f"run={rec['run_s']}s dominant={roof.dominant} "
                  f"terms=({roof.compute_s:.3e},{roof.memory_s:.3e},"
                  f"{roof.collective_s:.3e})s"
                  + (roof.against(rec["measured_s"])
                     if "measured_s" in rec else ""), flush=True)
    except Exception as e:  # noqa: BLE001 (recorded; the run goes on)
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"  FAIL {arch:24s} {shape_name:12s}: {rec['error'][:120]}",
                  flush=True)
    return rec


def run_cells(archs, shapes, *, multi_pod: bool, rules=None,
              cfg_overrides=None, out=None, verbose=True, mesh_shape=None,
              **kw) -> list:
    """Every (arch, shape) cell on one production mesh (or a ``(data,
    model)`` mesh of ``mesh_shape``), each record written to
    ``out/<arch>__<shape>__<tag>.json`` (``<tag>_zero1`` under ``zero1``);
    ``kw`` go to ``run_cell``."""
    records = []
    world = (mesh_shape[0] * mesh_shape[1] if mesh_shape
             else WORLD[multi_pod])
    with fake_ranks(world):
        if mesh_shape:
            mesh = make_host_mesh(*mesh_shape)
            tag = f"{mesh_shape[0]}x{mesh_shape[1]}"
        else:
            mesh = make_production_mesh(multi_pod=multi_pod)
            tag = "multipod" if multi_pod else "singlepod"
        if kw.get("zero1"):
            tag += "_zero1"
        if verbose:
            print(f"== mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
                  f"({dist.get_world_size()} fake ranks) ==", flush=True)
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mesh, rules=rules,
                               cfg_overrides=cfg_overrides, verbose=verbose,
                               **kw)
                records.append(rec)
                if out:
                    fn = os.path.join(out, f"{arch}__{shape}__{tag}.json")
                    with open(fn, "w") as fh:
                        json.dump(rec, fh, indent=1)
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None,
                    help="an arch id, as often as wanted (default all)")
    ap.add_argument("--shape", action="append", default=None,
                    help="a shape, as often as wanted (default all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--rule", action="append", default=[],
                    help="logical-axis rule override, e.g. seq=model")
    ap.add_argument("--set", action="append", default=[], dest="sets",
                    help="ArchConfig override, e.g. moe_impl=ep")
    ap.add_argument("--device", default="meta",
                    help="meta (the dry run) or cuda (the step for real)")
    ap.add_argument("--mesh", default=None,
                    help="a (data, model) mesh in place of the production "
                         "one, e.g. 1x1")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--zero1", action="store_true",
                    help="cut a train cell's AdamW slots over data (ZeRO-1)")
    args = ap.parse_args(argv)
    check_device(args.device, "dryrun")
    mesh_shape = (tuple(int(n) for n in args.mesh.split("x"))
                  if args.mesh else None)

    def _coerce(v):
        return int(v) if v.isdigit() else v
    cfg_overrides = {k: _coerce(v) for k, v in
                     (kv.split("=", 1) for kv in args.sets)} or None
    overrides = dict(r.split("=", 1) for r in args.rule) or None
    if overrides:
        overrides = {k: (None if v == "none" else v)
                     for k, v in overrides.items()}
    archs = args.arch or list(ARCHS)
    shapes = args.shape or list(SHAPES)
    meshes = ([False] if mesh_shape else [True, False] if args.both_meshes
              else [args.multi_pod])
    os.makedirs(args.out, exist_ok=True)
    records = []
    for mp in meshes:
        records += run_cells(archs, shapes, multi_pod=mp, rules=overrides,
                             cfg_overrides=cfg_overrides, out=args.out,
                             mesh_shape=mesh_shape, device=args.device,
                             batch=args.batch, seq=args.seq,
                             zero1=args.zero1)
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_fail = sum(r["status"] == "failed" for r in records)
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_fail} failed ==")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
