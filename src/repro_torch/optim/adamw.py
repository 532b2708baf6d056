"""AdamW and its schedule: the port of the JAX package's ``optim/adamw.py``,
formula for formula, over dicts of tensors keyed by parameter name.

State mirrors the parameters (``m``, ``v`` a leaf each, float32).  The
update runs in place on the parameters and the moments (the reference
returns new trees; on the card a copy of 1.7B parameters' state would cost
three times its 6.9 GB), with ``torch._foreach_*`` over all leaves, and in
chunks of at most ``CHUNK_ELEMENTS`` elements where it needs temporaries.
``step`` is an int32 0-d tensor on the CPU, so lr and the bias corrections
are the reference's float32 0-d arithmetic without a wait for the card.

On a model sharded over a ``model`` group, the global norm that clips the
grads is the whole model's: a sharded leaf's squares are summed over the
group, a replicated leaf (the same on every rank) counts once.

ZeRO-1 (:class:`Zero1`): each leaf whose slot spec cuts a dim over the
data group (``sharding.specs.slot_specs``) keeps only this data rank's
slice of its moments.  The step hands the update that slice of the mean
grad (:func:`scatter_grads`, one reduce_scatter); the update moves that
slice of the parameter, then one all_gather puts the updated slices back
into every rank's parameters.  The reference writes the layout as shardings
and leaves the gather and scatter to XLA; the port runs them explicitly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core.distributed import (all_gather_group, all_reduce,
                                         gather_dim, reduce_scatter_group)

# elements of the update's temporaries at once (two float32 buffers)
CHUNK_ELEMENTS = 1 << 28


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 [] on the CPU
    m: dict              # first moment {name: float32 tensor}
    v: dict              # second moment


class Zero1(NamedTuple):
    """ZeRO-1's cut of the slots over a data group: ``dims`` maps each leaf
    cut to the dim cut (a leaf not named keeps whole slots on every rank);
    ``group`` is the data dim's group, ``rank`` this rank's index in it,
    ``size`` its ranks; on a multi-pod mesh ``pod`` is the pods' group,
    over which the slices are replicated."""
    dims: dict
    group: object
    rank: int
    size: int
    pod: object = None

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``t`` (a leaf as the model holds it, or its
        grad; a view), or ``t`` for a leaf not cut."""
        d = self.dims.get(name)
        if d is None:
            return t
        n = t.shape[d] // self.size
        return t.narrow(d, self.rank * n, n)

    def whole(self, named: dict) -> dict:
        """The inverse of :meth:`local` over ``{name: slice}`` on every rank
        of the group: an all_gather a leaf cut."""
        return {k: t if k not in self.dims else gather_dim(
            t.contiguous(), self.group, self.dims[k], "gather_slots")
                for k, t in named.items()}


def adamw_init(params: dict, zero1: Zero1 = None) -> AdamWState:
    """Zero moments, float32, of the shape of each parameter (with
    ``zero1``, of this rank's slice of it)."""
    def zeros():
        return {k: torch.zeros((zero1.local(k, p) if zero1 else p).shape,
                               dtype=torch.float32, device=p.device)
                for k, p in params.items()}
    return AdamWState(torch.zeros((), dtype=torch.int32), zeros(), zeros())


def global_norm(tensors, split=(), group=None, cut=(),
                cut_group=None) -> torch.Tensor:
    """sqrt of the sum of squares over every element of the whole tensors
    that ``tensors`` are parts of: those whose flag in ``split`` is set are
    shards over ``group`` (the model dim), those whose flag in ``cut`` is
    set slices over ``cut_group`` (ZeRO-1's data dim); a tensor's squares
    are summed over each group it is cut over, so each element counts
    once."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if not any(split) and not any(cut):
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms) ** 2
    n = len(tensors)
    s = torch.tensor(list(split) or [False] * n, device=sq.device)
    c = torch.tensor(list(cut) or [False] * n, device=sq.device)

    def part(mask):
        return torch.where(mask, sq, 0.0).sum()
    if any(cut):
        over = all_reduce(torch.stack([part(s & c), part(~s & c)]),
                          cut_group, "grad_norm")
        shards, slices = over[0] + part(s & ~c), over[1]
    else:
        shards, slices = part(s), 0.0
    if any(split):
        shards = all_reduce(shards, group, "grad_norm")
    return torch.sqrt(shards + slices + part(~s & ~c))


def scatter_grads(grads: dict, zero1: Zero1) -> dict:
    """The mean over the data ranks of each grad of ``grads`` (leaves cut by
    ``zero1``), this rank's slice of it: one reduce_scatter of every leaf's
    slices laid rank-major, then on a multi-pod mesh one all_reduce over
    the pods.  The ring moves what the all_reduce of these leaves would
    have, half of it here, half in the all_gather after the update."""
    k = zero1.size
    names = list(grads)
    rows = [grads[n].unflatten(zero1.dims[n], (k, -1))
            .movedim(zero1.dims[n], 0).reshape(k, -1) for n in names]
    mine = reduce_scatter_group(torch.cat(rows, 1), zero1.group, 0,
                                "zero1_reduce_scatter")[0]
    ranks = k
    if zero1.pod is not None:
        mine = all_reduce(mine, zero1.pod, "zero1_all_reduce_pod")
        ranks *= dist.get_world_size(zero1.pod)
    mine = mine / ranks
    parts = mine.split([r.shape[1] for r in rows])
    return {n: part.view(zero1.local(n, grads[n]).shape)
            for n, part in zip(names, parts)}


def _gather_into(params: dict, zero1: Zero1) -> None:
    """Every rank's updated slice put back into each cut parameter, in
    place: one all_gather of them all."""
    names = [k for k in params if k in zero1.dims]
    if not names:
        return
    mine = [zero1.local(k, params[k]) for k in names]
    every = all_gather_group(torch.cat([t.reshape(-1) for t in mine]),
                             zero1.group, "zero1_all_gather")
    parts = every.split([t.numel() for t in mine], 1)
    for k, t, part in zip(names, mine, parts):
        d = zero1.dims[k]
        params[k].copy_(part.reshape(zero1.size, *t.shape).movedim(0, d)
                        .flatten(d, d + 1))


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step): linear warmup to ``base_lr``, then a cosine to a tenth of
    it at ``total``; float32 0-d of an int32 0-d step."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, base_lr * (0.1 + 0.9 * cos))
    return lr


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: AdamWState, *, lr_fn,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 clip_norm: float = 1.0, sharded=frozenset(),
                 model_group=None, zero1: Zero1 = None) -> tuple:
    """-> (params, new_state, metrics).  Clips ``grads`` to the global norm
    ``clip_norm`` (scaling them in place), then updates ``params`` and the
    moments in place; weight decay applies to every leaf.  The leaves
    named in ``sharded`` are shards over ``model_group``.  With ``zero1``
    the state holds the slots :func:`adamw_init` cut, ``grads`` holds this
    rank's slice of each cut leaf's (:func:`scatter_grads`), the update
    moves that slice of the parameter, and an all_gather over the data
    group then fills every rank's parameters."""
    cut = zero1.dims if zero1 is not None else {}
    names = list(params)
    p = [zero1.local(k, params[k]) if k in cut else params[k]
         for k in names]
    g = [grads[k].float() for k in names]
    m = [state.m[k] for k in names]
    v = [state.v[k] for k in names]
    gnorm = global_norm(g, [k in sharded for k in names], model_group,
                        [k in cut for k in names],
                        zero1.group if cut else None)
    scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
    torch._foreach_mul_(g, scale)
    step = state.step + 1
    t = step.to(torch.float32)
    lr = lr_fn(step)
    c1 = float(1.0 - b1 ** t)
    c2 = float(1.0 - b2 ** t)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, g, alpha=1 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, g, g, value=1 - b2)
    for lo, hi in _chunks(p):
        den = torch._foreach_div(v[lo:hi], c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(m[lo:hi], c1)
        torch._foreach_div_(upd, den)
        del den
        torch._foreach_add_(upd, p[lo:hi], alpha=weight_decay)
        torch._foreach_add_(p[lo:hi], upd, alpha=-float(lr))
    if cut:
        _gather_into(params, zero1)
    return params, AdamWState(step, state.m, state.v), \
        {"grad_norm": gnorm, "lr": lr}


def _chunks(tensors: list):
    """(lo, hi) ranges of ``tensors`` of at most ``CHUNK_ELEMENTS`` elements
    each (a larger tensor alone)."""
    lo, n = 0, 0
    for i, x in enumerate(tensors):
        if n and n + x.numel() > CHUNK_ELEMENTS:
            yield lo, i
            lo, n = i, 0
        n += x.numel()
    if lo < len(tensors):
        yield lo, len(tensors)
