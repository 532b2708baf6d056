"""RG-LRU recurrent mixer (recurrentgemma-2b), per arXiv:2402.19427 §2.4:
the port of the JAX package's ``models/rglru.py``.

Recurrent block: x -> [branch y: linear -> GeLU] x [branch h: linear ->
causal conv(4) -> RG-LRU] -> elementwise product -> out projection.

RG-LRU recurrence (gates use *block-diagonal* projections, width 256 — the
paper's trick to keep the gate cost linear in width):

    r_t = sigmoid(W_a x_t);  i_t = sigmoid(W_x x_t)
    a_t = a^(c * r_t)  with  log a = -8 * softplus(Lambda),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Train: associative scan over T (``ssm.associative_scan``; the transition
tensor is [B, T, lru] — same footprint as activations, no chunking needed).
Decode: O(1) update.

Tensor parallelism over ``lru`` (under ``sharding.specs.logical_rules``, the
model dim, where ``shard_params`` cut the channels): ``in_y`` and ``in_x``
are column-parallel, the conv and ``lam`` hold the local channels, ``out``
is row-parallel (one all_reduce of ``[N, d]``).  The gates' blocks
``wa``/``wx`` stay whole on every rank (``lru_blocks`` has no rule), as in
the reference.  Where a rank's channels are whole blocks, its gates take
its blocks and no collective; where they straddle blocks (320 channels a
rank of 256-wide blocks), one all_gather of the conv's output ``xc`` a
layer gives each rank the inputs of the blocks its channels lie in.  The
blocks enter through ``copy_to_group``: a rank's grad of them is its
channels' part.  Under sequence parallelism (the ``seq`` rule) the input
comes in as this rank's chunk of the sequence: f is an all_gather of it
and g a reduce_scatter (``layers``), the scan running on the whole
sequence of the local channels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.distributed import (copy_to_group, gather_from_group,
                                          gather_seq, reduce_from_group,
                                          scatter_seq)
from repro_torch.models.layers import COMPUTE_DTYPE, Init, Params
from repro_torch.models.ssm import associative_scan
from repro_torch.sharding.specs import model_axis

_C = 8.0


class RGLRUCache(NamedTuple):
    conv: torch.Tensor   # [B, d_conv - 1, lru]
    h: torch.Tensor      # [B, lru] (f32)
    pos: torch.Tensor    # [B]


def _dims(cfg):
    r = cfg.rglru
    lru = r.lru_width or cfg.d_model
    assert lru % r.block_width == 0
    return r, lru, lru // r.block_width


def init_rglru(init: Init, cfg) -> Params:
    r, lru, nb = _dims(cfg)
    bw = r.block_width
    # softplus^-1 so a ~ U(0.9, 0.999)
    u = init.uniform((lru,), 0.9, 0.999)
    return Params(
        in_y=init.dense((cfg.d_model, lru)),
        in_x=init.dense((cfg.d_model, lru)),
        conv_w=init.dense((r.d_conv, lru)) * 0.1,
        conv_b=init.zeros((lru,)),
        wa=init.dense((nb, bw, bw), in_axis=1),             # block-diagonal
        wx=init.dense((nb, bw, bw), in_axis=1),
        lam=torch.log(torch.expm1(-torch.log(u) / 8.0)),
        out=init.dense((lru, cfg.d_model)),
    )


def _block_proj(w, x, nb, bw):
    """Block-diagonal projection: x [..., nb * bw] @ blockdiag(w) -> same."""
    xs = x.reshape(x.shape[:-1] + (nb, bw))
    return torch.einsum("...nb,nbc->...nc", xs, w).reshape(x.shape)


def _tp(p, cfg):
    """The model dim when ``p`` holds a shard of the channels, else None."""
    return model_axis() if p["lam"].shape[0] < _dims(cfg)[1] else None


def _gates(p, xc, cfg, tp=None):
    """(a, bx) of the channels ``xc`` holds (this rank's, over ``tp``)."""
    r, lru, nb = _dims(cfg)
    bw = r.block_width
    xf = xc.float()
    width = xc.shape[-1]
    if tp is None:
        ra = _block_proj(p["wa"], xf, nb, bw)
        ix = _block_proj(p["wx"], xf, nb, bw)
    else:
        group = tp.group
        lo = tp.rank * width
        b0, b1 = lo // bw, -(-(lo + width) // bw)    # the blocks it lies in
        if width % bw:                               # straddles blocks
            xin = gather_from_group(xf, group)[..., b0 * bw:b1 * bw]
        else:
            xin = xf
        start = lo - b0 * bw

        def proj(w):
            w = copy_to_group(w, group)[b0:b1]
            return _block_proj(w, xin, b1 - b0, bw).narrow(-1, start, width)
        ra, ix = proj(p["wa"]), proj(p["wx"])
    rt = torch.sigmoid(ra)
    it = torch.sigmoid(ix)
    log_a = -_C * F.softplus(p["lam"]) * rt                # [..., lru]
    a = torch.exp(log_a)
    # multiplier sqrt(1 - a^2), stable via log: 0.5*log1p(-exp(2 log_a))
    mult = torch.exp(0.5 * torch.log1p(-torch.exp(2.0 * log_a) + 1e-9))
    bx = mult * it * xf
    return a, bx


def _conv(p, x, cfg, prefix=None):
    r = cfg.rglru
    B, T, width = x.shape
    if prefix is None:
        prefix = torch.zeros((B, r.d_conv - 1, width), dtype=x.dtype,
                             device=x.device)
    xp = torch.cat([prefix, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(r.d_conv):
        out = out + xp[:, i:i + T, :] * p["conv_w"][i].to(x.dtype)
    return out + p["conv_b"].to(x.dtype)


def rglru_train(p, x, cfg, sp=None) -> torch.Tensor:
    """x [B, T, d_model] -> [B, T, d_model]; this rank's chunks of the
    sequence under sequence parallelism (``sp``)."""
    c = COMPUTE_DTYPE
    tp = _tp(p, cfg)
    group = None if tp is None else tp.group
    if sp is not None and tp is None:
        raise NotImplementedError("sequence parallelism runs the RG-LRU with "
                                  "its channels cut over the model dim")
    x = copy_to_group(x, group) if sp is None else gather_seq(x, group)
    y = F.gelu(x @ p["in_y"].to(c), approximate="tanh")
    xb = x @ p["in_x"].to(c)
    xc = _conv(p, xb, cfg)
    a, bx = _gates(p, xc, cfg, tp)                         # [B, T, lru] f32
    _, hs = associative_scan(a, bx, dim=1)
    g = reduce_from_group if sp is None else scatter_seq
    return g((hs.to(c) * y) @ p["out"].to(c), group)


def init_rglru_cache(cfg, batch: int, device="cuda") -> RGLRUCache:
    r, lru, _ = _dims(cfg)
    return RGLRUCache(
        torch.zeros((batch, r.d_conv - 1, lru), dtype=COMPUTE_DTYPE,
                    device=device),
        torch.zeros((batch, lru), dtype=torch.float32, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def rglru_decode(p, x, cfg, cache: RGLRUCache):
    """x [B, 1, d_model] -> (y [B, 1, d_model], cache)."""
    c = COMPUTE_DTYPE
    tp = _tp(p, cfg)
    y = F.gelu(x[:, 0] @ p["in_y"].to(c), approximate="tanh")
    xb = x[:, 0] @ p["in_x"].to(c)                         # [B, lru]
    window = torch.cat([cache.conv, xb[:, None]], dim=1)
    xc = torch.einsum("btd,td->bd", window, p["conv_w"].to(c)) \
        + p["conv_b"].to(c)
    a, bx = _gates(p, xc, cfg, tp)                         # [B, lru]
    h = a * cache.h + bx
    out = reduce_from_group((h.to(c) * y) @ p["out"].to(c),
                            None if tp is None else tp.group)[:, None]
    return out, RGLRUCache(window[:, 1:], h, cache.pos + 1)
