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
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import COMPUTE_DTYPE, Init, Params
from repro_torch.models.ssm import associative_scan

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
    """Block-diagonal projection: x [..., lru] @ blockdiag(w) -> [..., lru]."""
    xs = x.reshape(x.shape[:-1] + (nb, bw))
    return torch.einsum("...nb,nbc->...nc", xs, w).reshape(x.shape)


def _gates(p, xc, cfg):
    r, lru, nb = _dims(cfg)
    bw = r.block_width
    xf = xc.float()
    rt = torch.sigmoid(_block_proj(p["wa"], xf, nb, bw))
    it = torch.sigmoid(_block_proj(p["wx"], xf, nb, bw))
    log_a = -_C * F.softplus(p["lam"]) * rt                # [..., lru]
    a = torch.exp(log_a)
    # multiplier sqrt(1 - a^2), stable via log: 0.5*log1p(-exp(2 log_a))
    mult = torch.exp(0.5 * torch.log1p(-torch.exp(2.0 * log_a) + 1e-9))
    bx = mult * it * xf
    return a, bx


def _conv(p, x, cfg, prefix=None):
    r, lru, _ = _dims(cfg)
    B, T, _ = x.shape
    if prefix is None:
        prefix = torch.zeros((B, r.d_conv - 1, lru), dtype=x.dtype,
                             device=x.device)
    xp = torch.cat([prefix, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(r.d_conv):
        out = out + xp[:, i:i + T, :] * p["conv_w"][i].to(x.dtype)
    return out + p["conv_b"].to(x.dtype)


def rglru_train(p, x, cfg) -> torch.Tensor:
    """x [B, T, d_model] -> [B, T, d_model]."""
    c = COMPUTE_DTYPE
    y = F.gelu(x @ p["in_y"].to(c), approximate="tanh")
    xb = x @ p["in_x"].to(c)
    xc = _conv(p, xb, cfg)
    a, bx = _gates(p, xc, cfg)                             # [B, T, lru] f32
    _, hs = associative_scan(a, bx, dim=1)
    return (hs.to(c) * y) @ p["out"].to(c)


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
    y = F.gelu(x[:, 0] @ p["in_y"].to(c), approximate="tanh")
    xb = x[:, 0] @ p["in_x"].to(c)                         # [B, lru]
    window = torch.cat([cache.conv, xb[:, None]], dim=1)
    xc = torch.einsum("btd,td->bd", window, p["conv_w"].to(c)) \
        + p["conv_b"].to(c)
    a, bx = _gates(p, xc, cfg)                             # [B, lru]
    h = a * cache.h + bx
    out = ((h.to(c) * y) @ p["out"].to(c))[:, None]
    return out, RGLRUCache(window[:, 1:], h, cache.pos + 1)
