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
int8-EF payload) and of the metrics over the group.  An MoE config's
capacity, load-balance loss and overflow are the global batch's, as in the
reference's one program over the mesh: its step runs under a
``logical_rules`` binding whose ``data`` dim is the group
(``models/moe.py``).

Tensor and expert parallelism: a model cut by ``sharding.specs.
shard_params`` over a mesh's ``model`` dim keeps each sharded leaf's grad
local (the f/g collectives of the layers already made it this rank's
part of the whole grad) and each replicated leaf's as it is (equal on
every model rank, never reduced over ``model``); the clipping norm sums
the shards' squares over ``model_group``.  Checkpoints gather the shards
to the reference's unsharded layout (``train_state_tree``), and
``load_train_state`` cuts a restored tree to this rank's shards, so a
checkpoint resumes at any (dp, tp).

ZeRO-1 (``zero1=True``): AdamW's slots are cut as ``sharding.specs.
slot_specs`` lays them out (the parameter's layout, the ``embed`` dim also
over the mesh's ``data`` dim; ``optim.adamw.Zero1``).  The step
reduce_scatters the cut leaves' grads over ``data`` in place of their
all_reduce (and all_reduces the slices over ``pod`` on a multi-pod mesh),
the update moves this rank's slices, and an all_gather over ``data`` fills
the parameters again: a ring moves the same bytes as plain DP's.  The
slots are gathered to the reference's layout for a checkpoint and cut
again on restore, so a checkpoint resumes at any (dp, tp, zero1).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core.distributed import all_reduce
from repro_torch.models.convert import stack_tree, unstack_tree
from repro_torch.models.model import Model
from repro_torch.optim.adamw import (AdamWState, Zero1, adamw_init,
                                     adamw_update, cosine_schedule,
                                     scatter_grads)
from repro_torch.optim.compress import ef_compress_grads
from repro_torch.sharding.specs import (DATA_AXES, bound_axis,
                                        current_binding, data_dim,
                                        gather_params, mesh_dims, shard_of,
                                        slot_specs)


class TrainState(NamedTuple):
    params: dict                      # {name: the model's nn.Parameter}
    opt: AdamWState
    ef_error: Optional[dict] = None   # int8-EF residuals (when enabled)


def train_state_init(model: Model, *, compress: bool = False,
                     zero1: bool = False, data_group=None) -> TrainState:
    """The model's parameters, zero moments (with ``zero1``, this rank's
    ZeRO-1 slots over ``data_group``: :func:`zero1_layout`, which the model
    keeps as ``model.zero1`` for ``train_state_tree`` and
    ``load_train_state``) and, with ``compress``, zero int8-EF
    residuals."""
    if zero1 and compress:
        raise ValueError("train_state_init: ZeRO-1 or int8-EF, not both")
    params = dict(model.named_parameters())
    ef = {k: torch.zeros_like(p, dtype=torch.float32)
          for k, p in params.items()} if compress else None
    model.zero1 = zero1_layout(model, data_group) if zero1 else None
    return TrainState(params, adamw_init(params, model.zero1), ef)


def zero1_layout(model: Model, data_group) -> Optional[Zero1]:
    """How ZeRO-1 cuts ``model``'s slots over ``data_group``: by
    ``slot_specs`` over the bound mesh (``logical_rules``, its rules), else
    the mesh the model was sharded over, else a ``data`` dim of the group's
    ranks.  None (the identity) without a group, with one of one rank, or
    where no leaf's slots are cut.
    On a mesh with a ``pod`` dim the group is the pods' data ranks
    together, and the slots are cut over ``data`` alone, replicated over
    ``pod``."""
    if data_group is None or dist.get_world_size(data_group) == 1:
        return None
    bind = current_binding()
    sharding = getattr(model, "sharding", None)
    mesh = bind[0] if bind is not None else \
        sharding.mesh if sharding is not None else None
    world = dist.get_world_size(data_group)
    if mesh is None or "data" not in mesh_dims(mesh):
        dims, group = {"data": world}, data_group
        rank, pod = dist.get_rank(data_group), None
    else:
        dims = mesh_dims(mesh)
        pods = dims.get("pod", 1)
        if pods * dims["data"] != world:
            raise ValueError(f"zero1: a data group of {world} ranks on a "
                             f"mesh of {dims}")
        group, rank = mesh.get_group("data"), mesh.get_local_rank("data")
        pod = mesh.get_group("pod") if pods > 1 else None
    specs = slot_specs(model, dims, None if bind is None else bind[1])
    for name, spec in specs.items():
        plain = tuple(None if a in DATA_AXES else a for a in spec)
        if sharding is not None and plain != tuple(sharding.specs[name]):
            raise ValueError(f"zero1: {name}'s slot spec {spec} cuts the "
                             f"model dims otherwise than its parameter's "
                             f"{sharding.specs[name]}")
    cut = {name: data_dim(spec) for name, spec in specs.items()
           if data_dim(spec) is not None}
    return Zero1(cut, group, rank, dims["data"], pod) if cut else None


def make_train_step(model: Model, *, lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, microbatches: int = 1,
                    data_group=None, compress_group=None, model_group=None,
                    zero1: bool = False):
    """Returns step(state, batch) -> (state, metrics).

    ``microbatches`` > 1 splits the batch on the leading axis, accumulates
    float32 grads one microbatch after another and averages grads and
    metrics.  ``data_group`` all-reduces the mean of the grads over a
    data-parallel group; ``compress_group`` does so through the int8
    error-feedback payload instead (the state then needs ``ef_error``,
    ``train_state_init(compress=True)``).  A model sharded over a mesh's
    ``model`` dim needs that dim's group as ``model_group`` and runs under
    ``logical_rules(mesh)``, as an MoE under data parallelism does (module
    docstring).  ``zero1`` cuts AdamW's slots over ``data_group``
    (``zero1_layout``; the state then comes from ``train_state_init(
    zero1=True)``): without a group, or with one of one rank, it is the
    identity.  The metrics are 0-d tensors: ``loss``, ``nll``, ``z_loss``
    (and the MoE's ``moe_aux_loss``, ``moe_overflow``), ``grad_norm``,
    ``lr``.
    """
    if data_group is not None and compress_group is not None:
        raise ValueError("make_train_step: data_group or compress_group, "
                         "not both")
    if zero1 and compress_group is not None:
        raise ValueError("make_train_step: ZeRO-1 or int8-EF, not both")
    cut = zero1_layout(model, data_group) if zero1 else None
    lr_fn = cosine_schedule(lr, warmup, total_steps)
    group = compress_group if compress_group is not None else data_group
    sharded = _sharded_leaves(model, model_group)
    moe_dp = group is not None and model.cfg.ff_kind == "moe" \
        and dist.get_world_size(group) > 1

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
        data = bound_axis("data") if moe_dp else None
        if moe_dp and (data is None
                       or data.size != dist.get_world_size(group)):
            raise RuntimeError("an MoE's capacity is the global batch's: run "
                               "its data-parallel step under logical_rules("
                               "mesh) whose data dim is the step's group")
        params = state.params
        _check_slots(state.opt, params, cut)
        for p in params.values():
            p.grad = None
        metrics = forward_backward(batch)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        ef = state.ef_error
        if compress_group is not None:
            grads, ef = ef_compress_grads(grads, ef, compress_group)
        elif cut is not None:
            rest = {k: g for k, g in grads.items() if k not in cut.dims}
            grads = {**scatter_grads({k: grads[k] for k in cut.dims}, cut),
                     **(_mean_over(rest, data_group) if rest else {})}
        elif data_group is not None:
            grads = _mean_over(grads, data_group)
        if group is not None:
            metrics = _mean_over(metrics, group, op="all_reduce_metrics")
        params, opt, om = adamw_update(params, grads, state.opt,
                                       lr_fn=lr_fn, sharded=sharded,
                                       model_group=model_group, zero1=cut)
        for p in params.values():
            p.grad = None
        return TrainState(params, opt, ef), {**metrics, **om}

    return step


def _check_slots(opt: AdamWState, params: dict, cut: Optional[Zero1]):
    """Raises unless ``opt``'s slots have the shapes ``cut`` gives them (a
    ZeRO-1 step on plain slots, or the other way round)."""
    for k, p in params.items():
        want = (cut.local(k, p) if cut is not None else p).shape
        if opt.m[k].shape != want:
            raise ValueError(f"make_train_step: {k}'s slot is "
                             f"{tuple(opt.m[k].shape)}, the step's layout "
                             f"{tuple(want)}: make the state by "
                             f"train_state_init(zero1=) as the step")


def _sharded_leaves(model: Model, model_group) -> frozenset:
    """The names of ``model``'s sharded leaves; checks that ``model_group``
    is the group of the mesh dim they are cut over."""
    sharding = getattr(model, "sharding", None)
    if sharding is None:
        return frozenset()
    size = mesh_dims(sharding.mesh).get("model", 1)
    names = frozenset(n for n, spec in sharding.specs.items()
                      if size > 1 and "model" in spec)
    if names and (model_group is None
                  or dist.get_world_size(model_group) != size):
        raise ValueError("make_train_step: a sharded model needs the group "
                         "of its mesh's model dim as model_group")
    return names


def _mean_over(tensors: dict, group, op: str = "all_reduce") -> dict:
    """The mean of each tensor over ``group``: one all_reduce of them all,
    metered under ``op``."""
    names = list(tensors)
    flat = torch.cat([tensors[n].reshape(-1) for n in names])
    flat = all_reduce(flat, group, op) / dist.get_world_size(group)
    parts = flat.split([tensors[n].numel() for n in names])
    return {n: part.view_as(tensors[n]) for n, part in zip(names, parts)}


# --- checkpoints in the reference's layout -------------------------------------

def train_state_tree(state: TrainState, model: Optional[Model] = None
                     ) -> TrainState:
    """``state`` in the JAX package's train-state layout: params, ``m``,
    ``v`` (and ``ef_error``) as nested dicts of float32 CPU tensors with
    the stacks stacked, ``step`` an int32 0-d tensor.  What
    ``runtime/checkpoint.save_checkpoint`` writes and ``restore_checkpoint``
    takes as its ``like_tree``.  For a sharded ``model`` the shards are
    gathered first, and ZeRO-1 slots over ``data`` before that (a
    collective: every rank of the mesh, or of the data group, calls it)."""
    sharding = getattr(model, "sharding", None)
    cut = getattr(model, "zero1", None)

    def whole(named: dict) -> dict:
        return named if sharding is None else gather_params(named, sharding)

    def slots(named: dict) -> dict:
        return stack_tree(whole(named if cut is None else cut.whole(named)))
    ef = None if state.ef_error is None else stack_tree(whole(state.ef_error))
    return TrainState(stack_tree(whole(state.params)),
                      AdamWState(state.opt.step.to("cpu", torch.int32,
                                                   copy=True),
                                 slots(state.opt.m), slots(state.opt.v)), ef)


@torch.no_grad()
def load_train_state(tree: TrainState, model: Model) -> TrainState:
    """The inverse of ``train_state_tree``: the tree's params copied into
    ``model``'s parameters, its moments (and residuals) onto their device;
    returns the model's train state.  A sharded ``model`` takes this rank's
    shard of every leaf, and this rank's ZeRO-1 slots where
    ``train_state_init(zero1=True)`` made the model's state so."""
    params = dict(model.named_parameters())
    sharding = getattr(model, "sharding", None)
    cut = getattr(model, "zero1", None)

    def local(name: str, leaf):
        leaf = torch.as_tensor(leaf)
        return leaf if sharding is None else shard_of(
            leaf, sharding.specs[name], sharding.mesh,
            sharding.parts_of(name))

    for name, leaf in unstack_tree(tree.params).items():
        params[name].copy_(local(name, leaf))

    def place(sub: dict, slots: Optional[Zero1] = None) -> dict:
        flat = unstack_tree(sub)
        return {k: (slots.local(k, local(k, flat[k])) if slots is not None
                    else local(k, flat[k])).to(p.device, torch.float32,
                                               copy=True)
                for k, p in params.items()}

    ef = None if tree.ef_error is None else place(tree.ef_error)
    step = torch.as_tensor(tree.opt.step).to("cpu", torch.int32, copy=True)
    return TrainState(params, AdamWState(step.reshape(()),
                                         place(tree.opt.m, cut),
                                         place(tree.opt.v, cut)), ef)
