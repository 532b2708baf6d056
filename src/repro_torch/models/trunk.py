"""The decoder trunk shared by 9 of the 10 archs: the port of the JAX
package's ``models/trunk.py``.

A *block* is one period of ``cfg.mixer_pattern`` (e.g. gemma2's
(local, attn), recurrentgemma's (rglru, rglru, local)); the trunk is
``n_layers / period`` blocks in an ``nn.ModuleList``, run by a Python loop
where the reference scans stacked parameters, plus an unscanned tail block
when the period does not divide the depth.  Each full block runs under the
reference's block remat (``layers.remat``: ``torch.utils.checkpoint`` where
the reference has ``jax.checkpoint``), the tail without, as there.  The
reference's layout hint on each mixer's input is a ``shard_hint`` check;
under the ``seq`` rule the blocks run sequence parallel (``sp``, the model
dim: ``layers``), the residual stream and the norms on this rank's chunk
of the sequence.  The Mamba mixer and the MoE have no sequence-parallel
form yet and raise under it.

Decode carries one cache dict per block, ``{"blocks": [...], "tail": ...}``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.sharding.specs import shard_hint


def _norm_init(init, cfg):
    return L.layernorm_init(init, cfg.d_model) if cfg.family == "audio" \
        else L.rmsnorm_init(init, cfg.d_model)


def _norm(p, x, cfg):
    return L.layernorm(p, x, cfg.norm_eps) if cfg.family == "audio" \
        else L.rmsnorm(p, x, cfg.norm_eps)


def _no_seq(sp, what: str) -> None:
    if sp is not None:
        raise NotImplementedError(f"{what} has no sequence-parallel form; "
                                  f"bind the seq rule without it")


def n_blocks(cfg) -> tuple:
    """(full blocks, tail mixers): depth = full * period + tail.

    A non-zero tail (e.g. recurrentgemma's 26 = 8 x 3 + 2) becomes one extra
    partial block using pattern[:tail]."""
    period = len(cfg.mixer_pattern)
    return cfg.n_layers // period, cfg.n_layers % period


def init_block(init, cfg, pattern=None) -> L.Params:
    pattern = pattern or cfg.mixer_pattern
    p = {}
    for i, kind in enumerate(pattern):
        p[f"pre_{i}"] = _norm_init(init, cfg)
        if kind in ("attn", "local"):
            p[f"mix_{i}"] = L.init_attention(init, cfg)
        elif kind == "mamba":
            p[f"mix_{i}"] = S.init_mamba(init, cfg)
        elif kind == "rglru":
            p[f"mix_{i}"] = R.init_rglru(init, cfg)
        else:
            raise ValueError(kind)
        if cfg.post_norms:
            p[f"postmix_{i}"] = _norm_init(init, cfg)
        if cfg.ff_kind != "none":
            p[f"ffpre_{i}"] = _norm_init(init, cfg)
            if cfg.ff_kind == "moe":
                p[f"ff_{i}"] = M.init_moe(init, cfg)
            else:
                p[f"ff_{i}"] = L.init_mlp(init, cfg)
            if cfg.post_norms:
                p[f"postff_{i}"] = _norm_init(init, cfg)
    return L.Params(**p)


def init_trunk(init, cfg) -> L.Params:
    nb, tail = n_blocks(cfg)
    p = {"blocks": nn.ModuleList([init_block(init, cfg) for _ in range(nb)])}
    if tail:
        p["tail"] = init_block(init, cfg, cfg.mixer_pattern[:tail])
    return L.Params(**p)


def _apply_ff(bp, i, x, cfg, aux, sp=None):
    h = _norm(L.seq_params(bp, sp)[f"ffpre_{i}"], x, cfg)
    if cfg.ff_kind == "moe":
        _no_seq(sp, "the MoE")
        moe_fn = M.moe_ffn_ep if cfg.moe_impl == "ep" else M.moe_ffn
        ff, a = moe_fn(bp[f"ff_{i}"], h, cfg)
        aux = {k: aux.get(k, 0.0) + v for k, v in a.items()}
    else:
        ff = L.mlp(bp[f"ff_{i}"], h, cfg, sp)
    if cfg.post_norms:
        ff = _norm(L.seq_params(bp, sp)[f"postff_{i}"], ff, cfg)
    return x + ff, aux


def block_train(bp, x, cfg, positions, pattern=None, sp=None) -> tuple:
    aux: dict = {}
    pattern = pattern or cfg.mixer_pattern
    norms = L.seq_params(bp, sp)
    B, T, d = x.shape
    whole = (B, T * (1 if sp is None else sp.size), d)
    for i, kind in enumerate(pattern):
        h = _norm(norms[f"pre_{i}"], x, cfg)
        h = shard_hint(h, ("batch", "seq", "embed"), whole)
        if kind == "attn":
            mx = L.attention_train(bp[f"mix_{i}"], h, cfg, kind="causal",
                                   positions=positions, sp=sp)
        elif kind == "local":
            mx = L.attention_train(bp[f"mix_{i}"], h, cfg, kind="local",
                                   positions=positions, sp=sp)
        elif kind == "mamba":
            _no_seq(sp, "the Mamba mixer")
            mx = S.mamba_train(bp[f"mix_{i}"], h, cfg)
        else:
            mx = R.rglru_train(bp[f"mix_{i}"], h, cfg, sp)
        if cfg.post_norms:
            mx = _norm(norms[f"postmix_{i}"], mx, cfg)
        x = x + mx
        if cfg.ff_kind != "none":
            x, aux = _apply_ff(bp, i, x, cfg, aux, sp)
    return x, aux


def trunk_train(tp, x, cfg, positions, sp=None) -> tuple:
    """x [B, T, d] -> (x, aux).  One block after another, each under block
    remat.  Under sequence parallelism (``sp``) ``x`` is this rank's chunk
    of the sequence and ``positions`` the whole sequence's."""
    dev = x.device
    aux = {"moe_aux_loss": torch.zeros((), dtype=torch.float32, device=dev),
           "moe_overflow": torch.zeros((), dtype=torch.float32, device=dev)} \
        if cfg.ff_kind == "moe" else {}
    for bp in tp["blocks"]:
        x, a = L.remat(cfg, block_train, bp, x, cfg, positions, None, sp)
        aux = {k: aux[k] + a.get(k, 0) for k in aux}
    if "tail" in tp:
        _, tail_len = n_blocks(cfg)
        x, a = block_train(tp["tail"], x, cfg, positions,
                           cfg.mixer_pattern[:tail_len], sp)
        aux = {k: aux[k] + a.get(k, 0) for k in aux}
    return x, aux


# --- decode -------------------------------------------------------------------

def init_block_cache(cfg, batch: int, max_seq: int, pattern=None,
                     device="cuda") -> dict:
    cache = {}
    pattern = pattern or cfg.mixer_pattern
    for i, kind in enumerate(pattern):
        if kind in ("attn", "local"):
            cache[f"c_{i}"] = L.init_kv_cache(cfg, batch, max_seq, kind,
                                              device=device)
        elif kind == "mamba":
            cache[f"c_{i}"] = S.init_mamba_cache(cfg, batch, device)
        else:
            cache[f"c_{i}"] = R.init_rglru_cache(cfg, batch, device)
    return cache


def init_trunk_cache(cfg, batch: int, max_seq: int, device="cuda") -> dict:
    """One cache dict a block (the reference stacks them over blocks)."""
    nb, tail = n_blocks(cfg)
    cache = {"blocks": [init_block_cache(cfg, batch, max_seq, device=device)
                        for _ in range(nb)]}
    if tail:
        cache["tail"] = init_block_cache(cfg, batch, max_seq,
                                         cfg.mixer_pattern[:tail], device)
    return cache


def block_decode(bp, x, cfg, cache: dict, pattern=None) -> tuple:
    new_cache = {}
    pattern = pattern or cfg.mixer_pattern
    for i, kind in enumerate(pattern):
        h = _norm(bp[f"pre_{i}"], x, cfg)
        if kind in ("attn", "local"):
            mx, nc = L.attention_decode(bp[f"mix_{i}"], h, cfg,
                                        cache[f"c_{i}"], kind=kind)
        elif kind == "mamba":
            mx, nc = S.mamba_decode(bp[f"mix_{i}"], h, cfg, cache[f"c_{i}"])
        else:
            mx, nc = R.rglru_decode(bp[f"mix_{i}"], h, cfg, cache[f"c_{i}"])
        new_cache[f"c_{i}"] = nc
        if cfg.post_norms:
            mx = _norm(bp[f"postmix_{i}"], mx, cfg)
        x = x + mx
        if cfg.ff_kind != "none":
            x, _ = _apply_ff(bp, i, x, cfg, {})
    return x, new_cache


def trunk_decode(tp, x, cfg, cache) -> tuple:
    """One-token step through all blocks; returns (x, new_cache)."""
    new_blocks = []
    for bp, cs in zip(tp["blocks"], cache["blocks"]):
        x, ncs = block_decode(bp, x, cfg, cs)
        new_blocks.append(ncs)
    new_cache = {"blocks": new_blocks}
    if "tail" in tp:
        _, tail_len = n_blocks(cfg)
        x, nt = block_decode(tp["tail"], x, cfg, cache["tail"],
                             cfg.mixer_pattern[:tail_len])
        new_cache["tail"] = nt
    return x, new_cache
