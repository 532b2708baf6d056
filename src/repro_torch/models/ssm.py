"""Mamba-1 selective-state-space mixer (falcon-mamba-7b): the port of the
JAX package's ``models/ssm.py``.

Train path: chunked associative scan — a loop over sequence chunks
(carrying the [B, d_inner, d_state] state) with a parallel prefix scan
inside each chunk.  The chunk bounds the [B, chunk, d_inner, d_state]
discretized-transition tensor that a full-sequence scan would materialize.
The in-chunk scan is Hillis-Steele (log2(chunk) whole-tensor steps), so it
combines in another order than ``lax.associative_scan``.

Decode path: O(1) recurrence update + conv ring buffer.

Tensor parallelism over ``d_inner`` (under ``sharding.specs.logical_rules``,
the model dim, where ``shard_params`` cut the channels): ``in_proj`` is
column-parallel and a rank holds ``[x_r | z_r]``, the same channels of
each half; the conv, ``dt_proj``, ``dt_bias``, ``A_log`` and ``D`` hold
the local channels; ``x_proj`` is row-parallel, and one all_reduce of
``[N, dt_rank + 2 d_state]`` makes ``dt``, ``B`` and ``C`` whole on every
rank (its grad sums back over the ranks, ``all_reduce_both_ways``); the
scan runs on the local channels with no collective; ``out_proj`` is
row-parallel (one all_reduce of ``[N, d]``).  Two all_reduces a layer in
the forward, train and decode alike; the decode cache holds the local
channels.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.distributed import (all_reduce_both_ways,
                                          copy_to_group, reduce_from_group)
from repro_torch.models.layers import COMPUTE_DTYPE, Init, Params
from repro_torch.sharding.specs import model_axis

SCAN_CHUNK = 256


class MambaCache(NamedTuple):
    conv: torch.Tensor   # [B, d_conv - 1, d_inner] rolling inputs
    h: torch.Tensor      # [B, d_inner, d_state] SSM state (f32)
    pos: torch.Tensor    # [B] int32


def _cfgdims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or math.ceil(cfg.d_model / 16)
    return s, d_inner, dt_rank


def init_mamba(init: Init, cfg) -> Params:
    s, d_inner, dt_rank = _cfgdims(cfg)
    A = torch.arange(1, s.d_state + 1, dtype=torch.float32,
                     device=init.device).repeat(d_inner, 1)
    return Params(
        in_proj=init.dense((cfg.d_model, 2 * d_inner)),
        conv_w=init.dense((s.d_conv, d_inner)) * 0.1,
        conv_b=init.zeros((d_inner,)),
        x_proj=init.dense((d_inner, dt_rank + 2 * s.d_state)),
        dt_proj=init.dense((dt_rank, d_inner)),
        dt_bias=init.full((d_inner,), -4.6),        # softplus ~ 0.01
        A_log=torch.log(A),
        D=init.full((d_inner,), 1.0),
        out_proj=init.dense((d_inner, cfg.d_model)),
    )


def associative_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1):
    """Inclusive scan of the linear recurrence h_t = a_t h_{t-1} + b_t along
    ``dim``: (prod a, h from h_{-1} = 0) at every t, the reference's
    ``combine`` ((a0, b0), (a1, b1)) -> (a0 a1, a1 b0 + b1) applied
    Hillis-Steele, t with t - off for off = 1, 2, 4, ..."""
    T = a.shape[dim]
    off = 1
    while off < T:
        a_lo, a_hi = a.narrow(dim, 0, T - off), a.narrow(dim, off, T - off)
        b_lo, b_hi = b.narrow(dim, 0, T - off), b.narrow(dim, off, T - off)
        a = torch.cat([a.narrow(dim, 0, off), a_hi * a_lo], dim)
        b = torch.cat([b.narrow(dim, 0, off), a_hi * b_lo + b_hi], dim)
        off *= 2
    return a, b


def _group(p, cfg):
    """The model dim's group when ``p`` holds a shard of the channels."""
    d_inner = _cfgdims(cfg)[1]
    return model_axis().group if p["D"].shape[0] < d_inner else None


def _x_proj(p, xc, group):
    """``xc @ x_proj`` [..., dt_rank + 2 d_state], summed over the model
    dim when the channels are sharded (one all_reduce)."""
    proj = xc @ p["x_proj"].to(xc.dtype)
    return all_reduce_both_ways(proj, group) if group is not None else proj


def _ssm_inputs(p, xc, proj, cfg):
    """Shared discretization: xc [..., d_inner] and its ``x_proj`` product
    -> (dA, dBx, C_ssm)."""
    s, _, dt_rank = _cfgdims(cfg)
    dt, B_ssm, C_ssm = torch.split(proj, [dt_rank, s.d_state, s.d_state],
                                   dim=-1)
    dt = F.softplus((dt @ p["dt_proj"].to(xc.dtype)).float()
                    + p["dt_bias"])                          # [..., d_inner]
    A = -torch.exp(p["A_log"])                               # [d_inner, state]
    dA = torch.exp(dt[..., None] * A)                        # [..., d_in, st]
    dBx = (dt * xc.float())[..., None] \
        * B_ssm.float()[..., None, :]                        # [..., d_in, st]
    return dA, dBx, C_ssm.float()


def _causal_conv(p, x, cfg, prefix=None):
    """Depthwise causal conv over T.  prefix [B, d_conv-1, d_inner] or zeros
    (``d_inner`` the channels ``x`` holds)."""
    s = cfg.ssm
    B, T, width = x.shape
    if prefix is None:
        prefix = torch.zeros((B, s.d_conv - 1, width), dtype=x.dtype,
                             device=x.device)
    xp = torch.cat([prefix, x], dim=1)                       # [B, T+dc-1, di]
    out = torch.zeros((B, T, width), dtype=x.dtype, device=x.device)
    for i in range(s.d_conv):                                # tiny unroll (4)
        out = out + xp[:, i:i + T, :] * p["conv_w"][i].to(x.dtype)
    return out + p["conv_b"].to(x.dtype)


def mamba_train(p, x, cfg) -> torch.Tensor:
    """x [B, T, d_model] -> [B, T, d_model]; T % SCAN_CHUNK == 0 (or T small)."""
    s = cfg.ssm
    B, T, _ = x.shape
    c = COMPUTE_DTYPE
    group = _group(p, cfg)
    x = copy_to_group(x, group)
    xz = x @ p["in_proj"].to(c)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(_causal_conv(p, x_in, cfg))                  # [B, T, d_inner]
    proj = _x_proj(p, xc, group)

    chunk = SCAN_CHUNK if T % SCAN_CHUNK == 0 else T
    h = torch.zeros((B, xc.shape[-1], s.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c0 in range(0, T, chunk):
        dA, dBx, C_ssm = _ssm_inputs(p, xc[:, c0:c0 + chunk],
                                     proj[:, c0:c0 + chunk], cfg)
        pA, pBx = associative_scan(dA, dBx, dim=1)           # [B, ch, di, st]
        hs = pA * h[:, None] + pBx
        ys.append(torch.einsum("bcds,bcs->bcd", hs, C_ssm))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1).to(c)
    y = y + p["D"].to(c) * xc
    y = y * F.silu(z)
    return reduce_from_group(y @ p["out_proj"].to(c), group)


def init_mamba_cache(cfg, batch: int, device="cuda") -> MambaCache:
    s, d_inner, _ = _cfgdims(cfg)
    return MambaCache(
        torch.zeros((batch, s.d_conv - 1, d_inner), dtype=COMPUTE_DTYPE,
                    device=device),
        torch.zeros((batch, d_inner, s.d_state), dtype=torch.float32,
                    device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def mamba_decode(p, x, cfg, cache: MambaCache):
    """One-token step: x [B, 1, d_model] -> (y [B, 1, d_model], cache)."""
    c = COMPUTE_DTYPE
    group = _group(p, cfg)
    xz = x[:, 0] @ p["in_proj"].to(c)
    x_in, z = torch.chunk(xz, 2, dim=-1)                     # [B, d_inner]
    window = torch.cat([cache.conv, x_in[:, None]], dim=1)
    xc = torch.einsum("btd,td->bd", window, p["conv_w"].to(c)) \
        + p["conv_b"].to(c)
    xc = F.silu(xc)
    dA, dBx, C_ssm = _ssm_inputs(p, xc, _x_proj(p, xc, group), cfg)
    h = dA * cache.h + dBx                                   # [B, di, st]
    y = torch.einsum("bds,bs->bd", h, C_ssm).to(c)
    y = y + p["D"].to(c) * xc
    y = y * F.silu(z)
    out = reduce_from_group(y @ p["out_proj"].to(c), group)[:, None]
    return out, MambaCache(window[:, 1:], h, cache.pos + 1)
