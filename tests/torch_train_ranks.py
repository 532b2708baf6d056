"""Rank functions of the port's training tests: torch and ``repro_torch``
only, so that ranks spawned by ``torch_dist.spawn`` never load JAX.  Each
returns plain Python values and numpy arrays."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed import COMM
from repro_torch.launch.train import make_batch_fn
from repro_torch.models import Model
from repro_torch.optim.compress import ef_compress_grads
from repro_torch.runtime.checkpoint import latest_step, save_checkpoint
from repro_torch.runtime.fault import elastic_restore
from repro_torch.runtime.train import (load_train_state, make_train_step,
                                       train_state_init, train_state_tree)


@contextlib.contextmanager
def compute_dtype(dtype):
    """The port's model stack computes in ``dtype`` (its modules'
    ``COMPUTE_DTYPE``), restored on exit."""
    from repro_torch.models import layers, moe, rglru, ssm
    mods = (layers, moe, ssm, rglru)
    saved = [m.COMPUTE_DTYPE for m in mods]
    for m in mods:
        m.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        for m, d in zip(mods, saved):
            m.COMPUTE_DTYPE = d


def train_span(mesh, dev, cfg, first: int, last: int, total: int,
               batch: int, seq: int, compress: bool = False,
               ckpt_dir=None, float32: bool = False) -> dict:
    """As ``_train_span``, in float32 compute when ``float32``."""
    with compute_dtype(torch.float32) if float32 else \
            contextlib.nullcontext():
        return _train_span(mesh, dev, cfg, first, last, total, batch, seq,
                           compress, ckpt_dir)


def _train_span(mesh, dev, cfg, first: int, last: int, total: int,
                batch: int, seq: int, compress: bool = False,
                ckpt_dir=None) -> dict:
    """Steps [first, last) of a run of ``total`` steps of ``cfg`` (weights
    from seed 0) on this rank's rows of the global ``lm_batch``; with
    ``mesh`` None, one process on the whole batch.  From ``ckpt_dir``'s
    newest checkpoint when ``first`` > 0; rank 0 writes one at ``last``.
    Returns the losses, the final params and residuals (numpy, by name),
    this rank's ``COMM`` meters and the step it started from."""
    torch.set_num_threads(1)
    group = None if mesh is None else mesh.get_group("data")
    rank = 0 if group is None else dist.get_rank(group)
    world = 1 if group is None else dist.get_world_size(group)
    model = Model(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(0))
    kw = {"compress_group" if compress else "data_group": group} \
        if group is not None else {}
    step = make_train_step(model, total_steps=total, warmup=2, **kw)
    state = train_state_init(model, compress=compress)
    start = 0
    if first:
        tree, start, _ = elastic_restore(ckpt_dir, train_state_tree(state),
                                         device="cpu")
        state = load_train_state(tree, model)
    batch_fn = make_batch_fn(cfg, batch, seq, device=dev, rank=rank,
                             world=world)
    COMM.reset()
    losses = []
    for i in range(start, last):
        state, m = step(state, batch_fn(i))
        losses.append(float(m["loss"]))
    if ckpt_dir is not None and rank == 0:
        save_checkpoint(ckpt_dir, last, train_state_tree(state))
    ef = state.ef_error or {}
    return {"losses": losses, "start": start,
            "params": {k: p.detach().cpu().numpy()
                       for k, p in state.params.items()},
            "ef_abs": float(sum(e.abs().sum() for e in ef.values())),
            "comm": COMM.snapshot(), "written": latest_step(ckpt_dir)
            if ckpt_dir is not None else None}


def ef_rank(mesh, dev, grads: list, errors: list) -> tuple:
    """``ef_compress_grads`` of this rank's ``grads[rank]`` with residuals
    ``errors[rank]`` (dicts of numpy arrays) over the data group."""
    group = mesh.get_group("data")
    r = dist.get_rank(group)

    def t(d):
        return {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
    out, new_e = ef_compress_grads(t(grads[r]), t(errors[r]), group)
    return ({k: v.cpu().numpy() for k, v in out.items()},
            {k: v.cpu().numpy() for k, v in new_e.items()})


def f16_mean(payloads: list) -> np.ndarray:
    """The reference's float16 psum of the ranks' payloads, divided by
    their count in float32 (gloo sums in rank order)."""
    acc = payloads[0]
    for p in payloads[1:]:
        acc = (acc + p).astype(np.float16)
    return acc.astype(np.float32) / np.float32(len(payloads))
