"""Shared neural layers: norms, rotary embedding, attention (GQA/MQA with
every assigned-arch option), dense MLP variants.  The port of the JAX
package's ``models/layers.py``, function for function.

Parameters live in :class:`Params` modules whose attributes carry the
reference's pytree names (``p["wq"]``), so a layer's code reads as the
reference's.  Compute dtype is bf16 with f32 softmax/norm accumulations;
params are f32 (cast at use — the standard mixed-precision recipe).
Attention is plain torch (einsum, a float32 softmax and, where
``attn_chunk`` divides a longer sequence, the chunked online softmax), as
the reference computes it with ``jnp`` outside any Pallas kernel.  Every
function is differentiated by autograd; ``remat`` is the block
rematerialisation the trunk and whisper's stacks apply.

Tensor parallelism (under ``sharding.specs.logical_rules``, over the
``model`` dim) is read off the shards ``shard_params`` cut: ``wq``/``wk``/
``wv`` (and their biases) are column-parallel by heads and kv heads where
``spec_for`` shards them, ``wo`` row-parallel; ``wg``/``wu`` column-parallel
by ff, ``wd`` row-parallel.  The input enters through ``copy_to_group``
(Megatron's f), a replicated parameter used on the local heads through it
too, and a row-parallel product ends in one ``reduce_from_group`` (g), a
row-parallel bias added after it.  The attention itself runs unchanged on
the local heads; whisper's cross-attention takes the encoder states'
keys and values of the local heads (``cross_kv``).

Sequence parallelism (where the ``seq`` rule cuts the sequence over the
``model`` dim, ``sharding.specs.seq_axis``), Megatron's: between the
layers a rank holds its chunk ``[B, T / tp, d]`` of the residual stream,
and the norms run on it.  Where a layer's weights shard, f becomes an
all_gather of the sequence (``gather_seq``, its grad a reduce_scatter) and
g a reduce_scatter (``scatter_seq``, its grad an all_gather), so the
layer's own work is the tensor-parallel one.  Where they do not (heads or
``ff`` that do not divide the dim), the layer works on the rank's chunk:
an attention's queries are its chunk's, against the keys and values of
the whole sequence (one all_gather of its input), and an MLP is pointwise.
A replicated parameter used on a chunk (the norms' scales, such layers'
weights, a bias added after g) reads through ``seq_params``: its grad is
summed over the dim (``copy_to_group``).

Decode on a sharded model (``attention_decode``) reads a cache whose
``k``/``v`` a rank holds ``S / tp`` positions of, for every kv head (the
``kv_seq`` rule, flash-decode sequence parallelism; it holds where the kv
heads do not divide the model dim).  Per attention layer and token: one
all_gather of the new token's q (and k, v where the kv heads shard) over
the heads; the new k and v go to the rank that owns the slot; each rank
attends all heads over its positions; the partial softmaxes combine by
the log-sum-exp rule (an all_reduce of the max, one of the sum of exps
and the weighted values together); ``wo`` is row-parallel where the
heads shard (one all_reduce).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.distributed import (all_reduce, copy_to_group,
                                          gather_group, gather_seq,
                                          reduce_from_group, scatter_seq)
from repro_torch.sharding.specs import current_binding, model_axis, rebind

COMPUTE_DTYPE = torch.bfloat16


class Params(nn.Module):
    """One layer's parameters as a module: trainable float32 tensors and
    sub-layers under the reference pytree's names, read as ``p["name"]``."""

    def __init__(self, **items):
        super().__init__()
        for name, v in items.items():
            if not isinstance(v, nn.Module):
                v = nn.Parameter(v)
            setattr(self, name, v)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class Init:
    """Seeded parameter initialiser on one device (the reference's
    ``jax.random`` keys become one ``torch.Generator``; the draws differ,
    the distributions are the reference's).  On the ``meta`` device the
    generator is None: shapes only, no memory."""

    def __init__(self, device, generator: Optional[torch.Generator]):
        self.device, self.gen = torch.device(device), generator

    def normal(self, shape, scale: float = 1.0) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=torch.float32) * scale

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        u = torch.rand(shape, generator=self.gen, device=self.device,
                       dtype=torch.float32)
        return lo + (hi - lo) * u

    def dense(self, shape, in_axis: int = 0) -> torch.Tensor:
        return self.normal(shape, 1.0 / math.sqrt(shape[in_axis]))

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=torch.float32,
                          device=self.device)


class _SeqParams:
    """``seq_params``' view of a layer's parameters."""

    def __init__(self, p, group):
        self.p, self.group = p, group

    def __getitem__(self, name: str):
        v = self.p[name]
        if isinstance(v, nn.Module):
            return _SeqParams(v, self.group)
        return copy_to_group(v, self.group)

    def __contains__(self, name: str) -> bool:
        return name in self.p


def seq_params(p, sp):
    """``p`` (a layer's ``Params``) read on this rank's chunk of the
    sequence: each parameter read goes through ``copy_to_group`` over
    ``sp``'s group, so its grad is the sum of the ranks'.  ``p`` itself
    without sequence parallelism (``sp`` None)."""
    return p if sp is None else _SeqParams(p, sp.group)


def remat(cfg, fn, *args):
    """``fn(*args)``; under ``cfg.remat == "block"`` (the reference's
    ``jax.checkpoint`` of a block) and while autograd records, its
    activations are dropped and recomputed in the backward.  The forward
    draws no random numbers, so no RNG state is kept for the recompute."""
    if cfg.remat == "block" and torch.is_grad_enabled():
        # the recompute may run on autograd's thread: bind what is bound
        binding = current_binding()

        def run(*a):
            with rebind(binding):
                return fn(*a)
        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def rmsnorm_init(init: Init, d: int) -> Params:
    return Params(scale=init.full((d,), 1.0))


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"])
    return out.to(x.dtype)


def layernorm_init(init: Init, d: int) -> Params:
    return Params(scale=init.full((d,), 1.0), bias=init.zeros((d,)))


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# --- rotary position embedding ----------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x [..., T, H, hd]; positions [..., T] (absolute).  theta==0 -> no-op
    (whisper uses absolute sinusoidal embeddings instead)."""
    if theta == 0.0:
        return x
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                 # [..., T, half]
    cos = torch.cos(ang)[..., None, :]                         # [..., T, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def sinusoidal_embedding(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freqs = 10000.0 ** (-torch.arange(half, dtype=torch.float32,
                                      device=positions.device)
                        / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --- attention ----------------------------------------------------------------

class KVCache(NamedTuple):
    """Decode cache.  ``k``/``v`` are [B, S, Hk, hd]; for local attention S is
    the window and writes wrap (ring buffer).  ``pos`` is the absolute
    position of the next token, int32 [B].  ``seq``: ``k``/``v`` hold this
    rank's ``S / tp`` of the positions over the model dim (set where
    ``Model.init_cache`` or ``sharding.specs.shard_cache`` cut them)."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    seq: bool = False


def init_attention(init: Init, cfg) -> Params:
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": init.dense((d, H * hd)),
        "wk": init.dense((d, Hk * hd)),
        "wv": init.dense((d, Hk * hd)),
        "wo": init.dense((H * hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = init.zeros((H * hd,))
        p["bk"] = init.zeros((Hk * hd,))
        p["bv"] = init.zeros((Hk * hd,))
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(init, hd)
        p["k_norm"] = rmsnorm_init(init, hd)
    return Params(**p)


def _tp_heads(p, cfg):
    """(model dim or None, local heads, local kv heads): the dim when
    ``wq`` holds a shard of the heads."""
    hd = cfg.hd
    H_l, Hk_l = p["wq"].shape[1] // hd, p["wk"].shape[1] // hd
    return (model_axis() if H_l < cfg.n_heads else None), H_l, Hk_l


def _project_qkv(p, x, cfg, positions, expand: bool = True,
                 gathered: bool = False):
    """(q, k, v) of the local heads, roped.  Where the kv heads are whole
    and the heads shard, k and v hold each local head's own kv group
    (``expand``) or every kv head (not ``expand``, for the decode cache).
    ``x`` enters through f, unless it is ``gathered`` (``gather_seq``'s,
    whose grad is already summed)."""
    B, T, _ = x.shape
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    c = COMPUTE_DTYPE
    tp, H_l, Hk_l = _tp_heads(p, cfg)
    group = None if tp is None else tp.group
    if not gathered:
        x = copy_to_group(x, group)
    kv_rep = tp is not None and Hk_l == Hk   # kv heads whole, heads split

    def kv(name):       # a replicated kv leaf, used on the local heads
        return copy_to_group(p[name], group) if kv_rep else p[name]
    q = x @ p["wq"].to(c)
    k = x @ kv("wk").to(c)
    v = x @ kv("wv").to(c)
    if cfg.qkv_bias:
        q = q + p["bq"].to(c)
        k = k + kv("bk").to(c)
        v = v + kv("bv").to(c)
    q = q.reshape(B, T, H_l, hd)
    k = k.reshape(B, T, Hk_l, hd)
    v = v.reshape(B, T, Hk_l, hd)
    if kv_rep and expand:
        k, v = _head_groups(k, v, tp, H_l, cfg)
    if cfg.qk_norm:
        q = rmsnorm({"scale": copy_to_group(p["q_norm"]["scale"], group)},
                    q, cfg.norm_eps)
        k = rmsnorm({"scale": copy_to_group(p["k_norm"]["scale"], group)},
                    k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _head_groups(k, v, tp, H_l, cfg):
    """Each of this rank's ``H_l`` heads' own kv group of the whole k/v."""
    idx = (tp.rank * H_l + torch.arange(H_l, device=k.device)) \
        // (cfg.n_heads // cfg.n_kv_heads)
    return k[:, :, idx], v[:, :, idx]


def _local_kv(p, k, v, cfg):
    """The keys and values of this rank's heads from ``k``/``v`` [B, S, n,
    hd] that hold either this rank's kv heads or every kv head."""
    tp, H_l, Hk_l = _tp_heads(p, cfg)
    Hk = cfg.n_kv_heads
    if tp is None or (Hk_l < Hk and k.shape[2] == Hk_l):
        return k, v
    if Hk_l < Hk:
        return (k.narrow(2, tp.rank * Hk_l, Hk_l),
                v.narrow(2, tp.rank * Hk_l, Hk_l))
    return _head_groups(k, v, tp, H_l, cfg)


def _out_proj(p, out, cfg, seq: bool = False):
    """``out @ wo``; summed over the model dim when ``wo`` holds a shard of
    the heads (and cut to this rank's chunk of the sequence when ``seq``)."""
    tp = _tp_heads(p, cfg)[0]
    y = out @ p["wo"].to(COMPUTE_DTYPE)
    group = None if tp is None else tp.group
    return scatter_seq(y, group) if seq else reduce_from_group(y, group)


def _sdpa(q, k, v, mask, cfg):
    """q [B,T,H,hd], k/v [B,S,Hk,hd], mask [B?,T,S] bool -> [B,T,H*hd]."""
    B, T, H, hd = q.shape
    S, Hk = k.shape[1], k.shape[2]
    g = H // Hk
    qg = q.reshape(B, T, Hk, g, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg, k).float()
    scores = scores / math.sqrt(hd)
    scores = softcap(scores, cfg.attn_softcap)
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(COMPUTE_DTYPE)
    out = torch.einsum("bkgts,bskh->btkgh", w, v)
    return out.reshape(B, T, H * hd)


def _chunked_sdpa(q, k, v, pos_q, pos_k, kind: str, cfg,
                  chunk: int) -> torch.Tensor:
    """Flash-style online-softmax attention: a loop over KV chunks (the
    reference's ``lax.scan``).

    Never materializes the [T, S] score matrix — peak extra memory is one
    [B, Hk, g, T, chunk] tile.
    q [B,T,H,hd]; k/v [B,S,Hk,hd]; pos_q [B,T]; pos_k [B,S]."""
    B, T, H, hd = q.shape
    S, Hk = k.shape[1], k.shape[2]
    g = H // Hk
    qg = q.reshape(B, T, Hk, g, hd)
    neg = -1e30
    m = torch.full((B, Hk, g, T), neg, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hk, g, T), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hk, g, T, hd), dtype=torch.float32,
                      device=q.device)
    i = pos_q[:, None, None, :, None]
    for c0 in range(0, S, chunk):
        kci, vci = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        j = pos_k[:, None, None, None, c0:c0 + chunk]
        s = torch.einsum("btkgh,bskh->bkgts", qg, kci).float()
        s = softcap(s / math.sqrt(hd), cfg.attn_softcap)
        if kind == "causal":
            s = torch.where(j <= i, s, neg)
        elif kind == "local":
            s = torch.where((j <= i) & (j > i - cfg.window), s, neg)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new[..., None])
        l = l * alpha + torch.sum(pexp, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgts,bskh->bkgth", pexp.to(COMPUTE_DTYPE), vci).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H * hd).to(
        COMPUTE_DTYPE)


def _mask(pos_q, pos_k, kind: str, cfg) -> torch.Tensor:
    """[B?, T, S] bool: which keys each query attends to."""
    i = pos_q[:, :, None]
    j = pos_k[:, None, :]
    if kind == "causal":
        return j <= i
    if kind == "local":
        return (j <= i) & (j > i - cfg.window)
    if kind == "full":
        return torch.ones_like(j <= i)
    raise ValueError(kind)


def _attend(q, k, v, pos_q, pos_k, kind: str, cfg, T: int):
    """The attention of ``q`` over ``k``/``v`` at these positions, chunked
    where ``attn_chunk`` divides a longer sequence of ``T``."""
    B = q.shape[0]
    chunk = cfg.attn_chunk
    if chunk and T % chunk == 0 and T > chunk:
        return _chunked_sdpa(q, k, v, pos_q.expand(B, -1),
                             pos_k.expand(B, -1), kind, cfg, chunk)
    return _sdpa(q, k, v, _mask(pos_q, pos_k, kind, cfg), cfg)


def attention_train(p, x, cfg, *, kind: str, positions=None,
                    kv: Optional[tuple] = None, sp=None) -> torch.Tensor:
    """Full-sequence attention.  kind: 'causal' | 'local' | 'full' | 'cross'.

    ``kv`` (pre-projected k, v) is used for cross-attention (whisper decoder
    over encoder states).  Under sequence parallelism (``sp``, the model
    dim) ``x`` and the output are this rank's chunk of the sequence and
    ``positions`` the whole sequence's (module docstring)."""
    B, T, _ = x.shape
    if sp is not None:
        T = T * sp.size
        if _tp_heads(p, cfg)[0] is None:
            return _attention_chunk(p, x, cfg, kind, positions, kv, sp)
        x = gather_seq(x, sp.group)
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=x.device)[None]
    seq = sp is not None
    if kind == "cross":
        assert kv is not None
        k, v = _local_kv(p, *kv, cfg)
        q = _project_qkv(p, x, cfg, positions, gathered=seq)[0]
        mask = torch.ones((B, T, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        return _out_proj(p, _sdpa(q, k, v, mask, cfg), cfg, seq)
    q, k, v = _project_qkv(p, x, cfg, positions, gathered=seq)
    return _out_proj(p, _attend(q, k, v, positions, positions, kind, cfg, T),
                     cfg, seq)


def _attention_chunk(p, x, cfg, kind, positions, kv, sp) -> torch.Tensor:
    """``attention_train`` under sequence parallelism where the heads do
    not shard: this rank's chunk's queries against the keys and values of
    the whole sequence (one all_gather of ``x``; a cross-attention's come
    whole from ``kv``), every parameter replicated and read through
    ``seq_params``."""
    B, T_l, _ = x.shape
    T = T_l * sp.size
    c = COMPUTE_DTYPE
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ps = seq_params(p, sp)
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32, device=x.device)[None]
    pos_q = positions[:, sp.rank * T_l:(sp.rank + 1) * T_l]
    q = x @ ps["wq"].to(c)
    if cfg.qkv_bias:
        q = q + ps["bq"].to(c)
    q = q.reshape(B, T_l, H, hd)
    if cfg.qk_norm:
        q = rmsnorm(ps["q_norm"], q, cfg.norm_eps)
    q = rope(q, pos_q, cfg.rope_theta)
    if kind == "cross":
        k, v = kv
        mask = torch.ones((B, T_l, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        return _sdpa(q, k, v, mask, cfg) @ ps["wo"].to(c)
    x_all = gather_seq(x, sp.group)
    k = x_all @ ps["wk"].to(c)
    v = x_all @ ps["wv"].to(c)
    if cfg.qkv_bias:
        k = k + ps["bk"].to(c)
        v = v + ps["bv"].to(c)
    k = k.reshape(B, T, Hk, hd)
    v = v.reshape(B, T, Hk, hd)
    if cfg.qk_norm:
        k = rmsnorm(ps["k_norm"], k, cfg.norm_eps)
    k = rope(k, positions, cfg.rope_theta)
    out = _attend(q, k, v, pos_q, positions, kind, cfg, T)
    return out @ ps["wo"].to(c)


def cross_kv(p, enc_out, cfg, whole: bool = False, sp=None,
             gathered: bool = False):
    """Pre-project encoder states for decoder cross-attention: the kv heads
    ``wk``/``wv`` hold (this rank's where they shard), or every kv head
    (``whole``, the decode cache's layout: one all_gather of the two
    weights' shards, cheaper than one of the [B, F] products once
    B F > 2 d).  Under the decoder's sequence parallelism (``sp``) where
    the heads do not shard, a rank's queries use the keys for its chunk
    only: the weights, and states whole on every rank, enter through f
    over ``sp``.  ``gathered`` states (``gather_seq``'s) carry their own
    grad sum."""
    B, S, _ = enc_out.shape
    c = COMPUTE_DTYPE
    tp, _, Hk_l = _tp_heads(p, cfg)
    group = None if tp is None else tp.group
    wk, wv = p["wk"], p["wv"]
    if whole and Hk_l < cfg.n_kv_heads:
        wk, wv = gather_group(torch.stack([wk, wv]), group)
        Hk_l = cfg.n_kv_heads
    elif tp is not None and Hk_l == cfg.n_kv_heads:
        wk, wv = copy_to_group(wk, group), copy_to_group(wv, group)
    elif tp is None and sp is not None:
        group = sp.group
        wk, wv = copy_to_group(wk, group), copy_to_group(wv, group)
    enc = enc_out if whole or gathered else copy_to_group(enc_out, group)
    k = (enc @ wk.to(c)).reshape(B, S, Hk_l, cfg.hd)
    v = (enc @ wv.to(c)).reshape(B, S, Hk_l, cfg.hd)
    return k, v


def _gather_heads(q, k, v, cfg, tp):
    """q (and k, v where the kv heads shard) [B, 1, n, hd] of the local
    heads -> of every head: one all_gather."""
    B, hd = q.shape[0], cfg.hd
    parts = [q, k, v] if k.shape[2] < cfg.n_kv_heads else [q]
    flat = torch.cat([t.reshape(B, -1) for t in parts], -1)
    g = gather_group(flat, tp.group).reshape(B, tp.size, -1)
    whole = [t.reshape(B, 1, -1, hd) for t in
             g.split([t.shape[2] * hd for t in parts], -1)]
    return (whole + [k, v])[:3]


def _sdpa_seq(q, k, v, mask, cfg, group):
    """``_sdpa`` over the positions a rank holds, combined over ``group``
    by the log-sum-exp rule: the max, then the sum of exps and the
    weighted values, each one all_reduce."""
    B, T, H, hd = q.shape
    S, Hk = k.shape[1], k.shape[2]
    qg = q.reshape(B, T, Hk, H // Hk, hd)
    s = torch.einsum("btkgh,bskh->bkgts", qg, k).float() / math.sqrt(hd)
    s = softcap(s, cfg.attn_softcap)
    s = torch.where(mask[:, None, None, :, :], s, -1e30)
    m = all_reduce(s.amax(dim=-1), group, "all_reduce_lse",
                   torch.distributed.ReduceOp.MAX)
    pexp = torch.exp(s - m[..., None])
    acc = torch.einsum("bkgts,bskh->bkgth", pexp.to(COMPUTE_DTYPE), v)
    both = all_reduce(torch.cat([pexp.sum(dim=-1)[..., None], acc.float()],
                                -1), group, "all_reduce_lse")
    out = both[..., 1:] / both[..., :1]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H * hd).to(
        COMPUTE_DTYPE)


def attention_decode(p, x, cfg, cache: KVCache, *, kind: str) -> tuple:
    """One-token decode with KV cache.  kind: 'causal' (S = max context) or
    'local' (S = window, ring buffer).  x [B, 1, d].  A cache whose
    ``seq`` is set holds this rank's ``S / tp`` positions over the model
    dim (module docstring).

    Writes the new key and value into ``cache.k``/``cache.v`` in place (the
    reference returns updated copies): a copy of a 4k-token cache a layer
    and step would move more bytes than the step's weights."""
    B = x.shape[0]
    S_l = cache.k.shape[1]
    pos = cache.pos                                          # [B]
    tp, H_l, _ = _tp_heads(p, cfg)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos[:, None], expand=False)
    if tp is not None:
        q, k_new, v_new = _gather_heads(q, k_new, v_new, cfg, tp)
    ax = model_axis() if cache.seq else None
    S, lo = (S_l, 0) if ax is None else (S_l * ax.size, ax.rank * S_l)
    if kind == "local":
        slot = pos % S
    else:
        slot = torch.clamp(pos, max=S - 1)
    bidx = torch.arange(B, device=x.device)
    k, v = cache.k, cache.v
    if ax is None:
        k[bidx, slot] = k_new[:, 0].to(k.dtype)
        v[bidx, slot] = v_new[:, 0].to(v.dtype)
    else:               # only the rank that holds the slot writes it
        mine = ((slot >= lo) & (slot < lo + S_l))[:, None, None]
        at = torch.clamp(slot - lo, 0, S_l - 1)
        for buf, new in ((k, k_new), (v, v_new)):
            buf[bidx, at] = torch.where(mine, new[:, 0].to(buf.dtype),
                                        buf[bidx, at])
    sidx = torch.arange(lo, lo + S_l, dtype=torch.int32,
                        device=x.device)[None]
    if kind == "local":
        # absolute position last written into each slot
        p_slot = pos[:, None] - torch.remainder(pos[:, None] - sidx, S)
        mask = (p_slot >= 0) & (p_slot <= pos[:, None])
    else:
        mask = sidx <= pos[:, None]
    kc, vc = k.to(COMPUTE_DTYPE), v.to(COMPUTE_DTYPE)
    out = _sdpa(q, kc, vc, mask[:, None, :], cfg) if ax is None \
        else _sdpa_seq(q, kc, vc, mask[:, None, :], cfg, ax.group)
    if tp is not None:
        out = out.narrow(-1, tp.rank * H_l * cfg.hd, H_l * cfg.hd)
    return _out_proj(p, out, cfg), cache._replace(pos=pos + 1)


def init_kv_cache(cfg, batch: int, max_seq: int, kind: str,
                  dtype=COMPUTE_DTYPE, device="cuda") -> KVCache:
    S = cfg.window if kind == "local" else max_seq
    shape = (batch, S, cfg.n_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device))


# --- dense feed-forward -------------------------------------------------------

def init_mlp(init: Init, cfg) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.ff_kind in ("swiglu", "geglu"):
        return Params(wg=init.dense((d, ff)), wu=init.dense((d, ff)),
                      wd=init.dense((ff, d)))
    return Params(wu=init.dense((d, ff)), bu=init.zeros((ff,)),
                  wd=init.dense((ff, d)), bd=init.zeros((d,)))


def mlp(p, x, cfg, sp=None) -> torch.Tensor:
    """The dense feed-forward; column- then row-parallel over the model dim
    when ``wd`` holds a shard of ``ff``.  Under sequence parallelism
    (``sp``) ``x`` and the output are this rank's chunk of the sequence
    (module docstring)."""
    c = COMPUTE_DTYPE
    tp = model_axis() if p["wd"].shape[0] < cfg.d_ff else None
    group = None if tp is None else tp.group
    if sp is None:
        x = copy_to_group(x, group)
        g = reduce_from_group
    elif tp is None:                     # pointwise on this rank's chunk
        p = seq_params(p, sp)
        g = reduce_from_group
    else:
        x = gather_seq(x, group)
        g = scatter_seq
    if cfg.ff_kind == "swiglu":
        return g((F.silu(x @ p["wg"].to(c)) * (x @ p["wu"].to(c)))
                 @ p["wd"].to(c), group)
    if cfg.ff_kind == "geglu":
        return g((F.gelu(x @ p["wg"].to(c), approximate="tanh")
                  * (x @ p["wu"].to(c))) @ p["wd"].to(c), group)
    h = F.gelu(x @ p["wu"].to(c) + p["bu"].to(c), approximate="tanh")
    # a bias added after g is used on this rank's chunk under sp
    bd = p["bd"] if sp is None or tp is None else seq_params(p, sp)["bd"]
    return g(h @ p["wd"].to(c), group) + bd.to(c)
