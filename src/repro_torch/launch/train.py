"""Training launcher: config -> data -> guarded steps -> checkpoints, with
elastic restore at start: the port of the JAX package's
``launch/train.py``, on the card unless ``--device cpu`` asks for the CPU.

``--dp N --tp M`` trains on N x M ranks (``launch/mesh.run_ranks``: gloo
on the CPU, NCCL with a card a rank, gloo over the card only when
``--dist-backend gloo`` asks) on the ``(data, model)`` mesh
``make_host_mesh(dp, tp)``, bound by ``logical_rules``: each data rank
takes its rows of the global batch, the model is cut into tensor- and
expert-parallel shards over ``model`` (``sharding.specs.shard_params``),
and the step all-reduces the mean of the grads over ``data``.  Every arch
takes ``--tp``, the Mamba, RG-LRU and whisper families included.
Checkpoints are gathered to rank 0 in the JAX package's train-state
layout (Mamba's ``in_proj`` whole, its halves put back), so either
package, and any (dp, tp), resumes them.  ``--kill-after STEP`` is a
fault drill: the process kills itself once the checkpoint of that step
is on disk; a rerun resumes from it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen2-0.5b --reduced --steps 20 [--dp 2] [--tp 2] \\
      [--ckpt-dir DIR --ckpt-every 10]
"""

from __future__ import annotations

import argparse
import os
import signal
import time

import torch
import torch.distributed as dist

from repro_torch.data.pipeline import lm_batch
from repro_torch.launch.mesh import backend_for, check_device, run_ranks
from repro_torch.models import ARCHS, Model
from repro_torch.models.model import CLIP_DIM
from repro_torch.runtime.checkpoint import save_checkpoint
from repro_torch.runtime.fault import (StragglerMonitor, elastic_restore,
                                       guarded_step)
from repro_torch.runtime.train import (load_train_state, make_train_step,
                                       train_state_init, train_state_tree)
from repro_torch.sharding.specs import logical_rules, shard_params


def make_batch_fn(cfg, batch: int, seq: int, seed: int = 0, *,
                  device="cuda", rank: int = 0, world: int = 1):
    """Deterministic per-step batch generator: this rank's rows of the
    global batch of ``batch`` rows (shard 0), on ``device``."""
    if batch % world:
        raise ValueError(f"batch {batch} does not split over {world} ranks")
    rows = slice(rank * batch // world, (rank + 1) * batch // world)
    local = batch // world

    def fn(step: int) -> dict:
        b = lm_batch(step, 0, batch=batch, seq=seq, vocab=cfg.vocab,
                     seed=seed, structured=True, device=device)
        b = {k: v[rows] for k, v in b.items()}
        if cfg.num_img_tokens:
            b["img_embeds"] = torch.zeros((local, cfg.num_img_tokens,
                                           CLIP_DIM), device=device)
        if cfg.is_encdec:
            e = cfg.encoder
            b["frames"] = torch.zeros((local, e.n_frames, e.d_input),
                                      device=device)
        return b

    return fn


def arch_config(arch: str, reduced: bool):
    cfg = ARCHS[arch]
    if reduced:
        cfg = cfg.reduced(vocab=512, d_model=128, d_ff=256,
                          n_layers=len(cfg.mixer_pattern) * 2)
    return cfg


def run(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 128,
        reduced: bool = True, lr: float = 3e-4, microbatches: int = 1,
        ckpt_dir: str | None = None, ckpt_every: int = 50,
        log_every: int = 10, dp: int = 1, tp: int = 1, seed: int = 0,
        device="cuda", dist_backend: str | None = None,
        kill_after: int | None = None) -> dict:
    """Train ``arch`` for ``steps`` steps; returns rank 0's losses and last
    metrics.  Raises without a card unless ``device`` is the CPU."""
    check_device(device, "train")
    kw = dict(arch=arch, steps=steps, batch=batch, seq=seq, reduced=reduced,
              lr=lr, microbatches=microbatches, ckpt_dir=ckpt_dir,
              ckpt_every=ckpt_every, log_every=log_every, seed=seed,
              kill_after=kill_after)
    if dp * tp == 1:
        return _train(device=torch.device(device), **kw)
    return run_ranks(_train_rank, dp * tp, (kw,),
                     backend=backend_for(device, dist_backend),
                     device=device, mesh_shape=(dp, tp),
                     timeout_s=3600.0)[0]


def _train_rank(mesh, device, kw):
    with logical_rules(mesh):
        return _train(device=device, mesh=mesh, **kw)


def _train(*, arch, steps, batch, seq, reduced, lr, microbatches, ckpt_dir,
           ckpt_every, log_every, seed, kill_after, device,
           mesh=None) -> dict:
    dp, tp = (1, 1) if mesh is None else tuple(mesh.shape)
    data = None if dp == 1 else mesh.get_group("data")
    rank = 0 if data is None else dist.get_rank(data)
    lead = mesh is None or dist.get_rank() == 0
    cfg = arch_config(arch, reduced)
    model = Model(cfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(seed))
    if tp > 1:
        shard_params(model, mesh)
    step_fn = make_train_step(
        model, lr=lr, total_steps=steps, warmup=max(steps // 20, 5),
        microbatches=microbatches, data_group=data,
        model_group=mesh.get_group("model") if tp > 1 else None)
    batch_fn = make_batch_fn(cfg, batch, seq, seed, device=device,
                             rank=rank, world=dp)
    monitor = StragglerMonitor()
    state = train_state_init(model)
    start = 0
    if ckpt_dir:
        tree, start, _ = elastic_restore(ckpt_dir,
                                         train_state_tree(state, model),
                                         device="cpu")
        if start:
            state = load_train_state(tree, model)
            if lead:
                print(f"[train] resumed from step {start}", flush=True)
    metrics: dict = {}
    losses = []
    writer = None
    for step in range(start, steps):
        t0 = time.perf_counter()
        state, metrics = guarded_step(step_fn, state, batch_fn(step))
        losses.append(float(metrics["loss"]))
        dt = time.perf_counter() - t0
        monitor.record(f"rank{rank}", dt)
        if lead and (step % log_every == 0 or step == steps - 1):
            print(f"[train] step {step:5d} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"dt={dt * 1e3:.0f}ms", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            tree = _tree(state, model, lead)      # every rank gathers
            if lead:
                _join(writer)
                writer = save_checkpoint(ckpt_dir, step + 1, tree,
                                         sync=False)
                if step + 1 == kill_after:
                    _join(writer)
                    print(f"[train] killed after the checkpoint of step "
                          f"{step + 1}", flush=True)
                    os.kill(os.getpid(), signal.SIGKILL)
    if ckpt_dir:
        tree = _tree(state, model, lead)
        if lead:
            _join(writer)
            save_checkpoint(ckpt_dir, steps, tree, sync=True)
    return {"final_loss": losses[-1] if losses else None,
            "first_loss": losses[0] if losses else None,
            "losses": losses, "start": start,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _tree(state, model, lead: bool):
    """The checkpoint's tree on rank 0: gathered on every rank of a sharded
    model (a collective), built on rank 0 alone otherwise."""
    if lead or getattr(model, "sharding", None) is not None:
        return train_state_tree(state, model)
    return None


def _join(writer) -> None:
    """Wait for an async checkpoint writer; raise what it raised."""
    if writer is None:
        return
    writer.join()
    if writer.exception is not None:
        raise RuntimeError("checkpoint write failed") from writer.exception


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="the ranks' backend: nccl on the card (a card a "
                         "rank) unless gloo is asked for, gloo on the CPU")
    ap.add_argument("--kill-after", type=int, default=None,
                    help="fault drill: SIGKILL this process once the "
                         "checkpoint of this step is written")
    args = ap.parse_args()
    out = run(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
              reduced=args.reduced, lr=args.lr,
              microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, dp=args.dp, tp=args.tp,
              device=args.device, dist_backend=args.dist_backend,
              kill_after=args.kill_after)
    where = check_device(args.device, "train")
    mesh = f"dp {args.dp} x tp {args.tp}"
    if out["losses"]:
        print(f"[train] done on {where}, {mesh}: loss "
              f"{out['first_loss']:.4f} -> {out['final_loss']:.4f}")
    else:
        print(f"[train] done on {where}, {mesh}: nothing left after "
              f"step {out['start']}")


if __name__ == "__main__":
    main()
