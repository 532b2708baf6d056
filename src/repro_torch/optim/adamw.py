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
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.distributed import all_reduce

# elements of the update's temporaries at once (two float32 buffers)
CHUNK_ELEMENTS = 1 << 28


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 [] on the CPU
    m: dict              # first moment {name: float32 tensor}
    v: dict              # second moment


def adamw_init(params: dict) -> AdamWState:
    return AdamWState(torch.zeros((), dtype=torch.int32),
                      {k: torch.zeros_like(p, dtype=torch.float32)
                       for k, p in params.items()},
                      {k: torch.zeros_like(p, dtype=torch.float32)
                       for k, p in params.items()})


def global_norm(tensors, split=(), group=None) -> torch.Tensor:
    """sqrt of the sum of squares over every element of ``tensors``; the
    tensors whose flag in ``split`` is set are shards, their squares summed
    over ``group`` too."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if not any(split):
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms) ** 2
    mask = torch.tensor(split, device=sq.device)
    part = all_reduce(torch.where(mask, sq, 0.0).sum(), group, "grad_norm")
    return torch.sqrt(part + torch.where(mask, 0.0, sq).sum())


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
                 model_group=None) -> tuple:
    """-> (params, new_state, metrics).  Clips ``grads`` to the global norm
    ``clip_norm`` (scaling them in place), then updates ``params`` and the
    moments in place; weight decay applies to every leaf.  The leaves
    named in ``sharded`` are shards over ``model_group``."""
    names = list(params)
    p = [params[k] for k in names]
    g = [grads[k].float() for k in names]
    m = [state.m[k] for k in names]
    v = [state.v[k] for k in names]
    gnorm = global_norm(g, [k in sharded for k in names], model_group)
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
