"""Train-step factory: loss -> grads -> AdamW, with gradient-accumulation
microbatching, block remat (in the trunk), data parallelism over a
``torch.distributed`` group and optional int8 error-feedback compression
of its all-reduce: the port of the JAX package's ``runtime/train.py``.

The step runs eagerly on the model's device.  The state's ``params`` are
the model's own parameters, updated in place, so a restored state is loaded
into the model (``load_train_state``).  Train checkpoints are written in the
reference's layout (``train_state_tree``): the stacks stacked, the names of
``models/convert.params_to_jax``, ``step`` an int32 0-d array, so either
package restores the other's files.

Data parallelism: each rank computes the loss of its rows of the global
batch, and the step all-reduces the mean of the float32 grads (or of their
int8-EF payload) and of the metrics over the group.  For an MoE config a
rank's expert capacity and load-balance loss come from its own tokens,
where the reference's one program over the mesh sees the global batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core.distributed import all_reduce
from repro_torch.models.convert import stack_tree, unstack_tree
from repro_torch.models.model import Model
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     cosine_schedule)
from repro_torch.optim.compress import ef_compress_grads


class TrainState(NamedTuple):
    params: dict                      # {name: the model's nn.Parameter}
    opt: AdamWState
    ef_error: Optional[dict] = None   # int8-EF residuals (when enabled)


def train_state_init(model: Model, *, compress: bool = False) -> TrainState:
    params = dict(model.named_parameters())
    ef = {k: torch.zeros_like(p, dtype=torch.float32)
          for k, p in params.items()} if compress else None
    return TrainState(params, adamw_init(params), ef)


def make_train_step(model: Model, *, lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, microbatches: int = 1,
                    data_group=None, compress_group=None):
    """Returns step(state, batch) -> (state, metrics).

    ``microbatches`` > 1 splits the batch on the leading axis, accumulates
    float32 grads one microbatch after another and averages grads and
    metrics.  ``data_group`` all-reduces the mean of the grads over a
    data-parallel group; ``compress_group`` does so through the int8
    error-feedback payload instead (the state then needs ``ef_error``,
    ``train_state_init(compress=True)``).  The metrics are 0-d tensors:
    ``loss``, ``nll``, ``z_loss`` (and the MoE's ``moe_aux_loss``,
    ``moe_overflow``), ``grad_norm``, ``lr``.
    """
    if data_group is not None and compress_group is not None:
        raise ValueError("make_train_step: data_group or compress_group, "
                         "not both")
    lr_fn = cosine_schedule(lr, warmup, total_steps)
    group = compress_group if compress_group is not None else data_group

    def forward_backward(batch) -> dict:
        if microbatches == 1:
            loss, metrics = model.loss(batch)
            loss.backward()
            return {k: v.detach().float() for k, v in metrics.items()}
        macc = None
        for i in range(microbatches):
            mb = {k: v.reshape((microbatches, -1) + v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, metrics = model.loss(mb)
            loss.backward()
            metrics = {k: v.detach().float() for k, v in metrics.items()}
            macc = metrics if macc is None else \
                {k: macc[k] + metrics[k] for k in macc}
        inv = 1.0 / microbatches
        torch._foreach_mul_([p.grad for p in model.parameters()
                             if p.grad is not None], inv)
        return {k: v * inv for k, v in macc.items()}

    def step(state: TrainState, batch) -> tuple:
        params = state.params
        for p in params.values():
            p.grad = None
        metrics = forward_backward(batch)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        ef = state.ef_error
        if compress_group is not None:
            grads, ef = ef_compress_grads(grads, ef, compress_group)
        elif data_group is not None:
            grads = _mean_over(grads, data_group)
        if group is not None:
            metrics = _mean_over(metrics, group, op="all_reduce_metrics")
        params, opt, om = adamw_update(params, grads, state.opt,
                                       lr_fn=lr_fn)
        for p in params.values():
            p.grad = None
        return TrainState(params, opt, ef), {**metrics, **om}

    return step


def _mean_over(tensors: dict, group, op: str = "all_reduce") -> dict:
    """The mean of each tensor over ``group``: one all_reduce of them all,
    metered under ``op``."""
    names = list(tensors)
    flat = torch.cat([tensors[n].reshape(-1) for n in names])
    flat = all_reduce(flat, group, op) / dist.get_world_size(group)
    parts = flat.split([tensors[n].numel() for n in names])
    return {n: part.view_as(tensors[n]) for n, part in zip(names, parts)}


# --- checkpoints in the reference's layout -------------------------------------

def train_state_tree(state: TrainState) -> TrainState:
    """``state`` in the JAX package's train-state layout: params, ``m``,
    ``v`` (and ``ef_error``) as nested dicts of float32 CPU tensors with
    the stacks stacked, ``step`` an int32 0-d tensor.  What
    ``runtime/checkpoint.save_checkpoint`` writes and ``restore_checkpoint``
    takes as its ``like_tree``."""
    ef = None if state.ef_error is None else stack_tree(state.ef_error)
    return TrainState(stack_tree(state.params),
                      AdamWState(state.opt.step.to("cpu", torch.int32,
                                                   copy=True),
                                 stack_tree(state.opt.m),
                                 stack_tree(state.opt.v)), ef)


@torch.no_grad()
def load_train_state(tree: TrainState, model: Model) -> TrainState:
    """The inverse of ``train_state_tree``: the tree's params copied into
    ``model``'s parameters, its moments (and residuals) onto their device;
    returns the model's train state."""
    params = dict(model.named_parameters())
    for name, leaf in unstack_tree(tree.params).items():
        params[name].copy_(leaf)

    def place(sub: dict) -> dict:
        flat = unstack_tree(sub)
        return {k: flat[k].to(p.device, torch.float32, copy=True)
                for k, p in params.items()}

    ef = None if tree.ef_error is None else place(tree.ef_error)
    step = torch.as_tensor(tree.opt.step).to("cpu", torch.int32, copy=True)
    return TrainState(params, AdamWState(step.reshape(()),
                                         place(tree.opt.m),
                                         place(tree.opt.v)), ef)
