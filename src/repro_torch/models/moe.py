"""Mixture-of-Experts feed-forward (moonshot 64e/top-6+2sh, qwen2-moe
60e/top-4+4sh): the port of the JAX package's ``moe_ffn`` and of its
expert-parallel ``moe_ffn_ep``.

Sort-based capacity dispatch: flatten (token, choice) pairs, sort by expert
(stably), rank within expert runs, drop beyond the static capacity C,
gather tokens into [E, C, d] buckets, run the expert FFNs as one batched
matmul, scatter-add back with the router weights.  Capacity overflow is
counted and returned (aux).

One dispatch body serves every layout.  Outside a ``logical_rules``
binding it is the reference's ``moe_ffn``.  Under a binding, tokens never
move: this data rank's rows reach every rank of the ``model`` dim, each
routes them (the router is replicated) to the experts it holds, and one
``reduce_from_group`` sums the partial outputs, shared experts included:

* block-EP (``E % tp == 0``): a rank holds ``E / tp`` whole experts; a
  choice of another rank's expert is dropped to slot ``E_l * C``;
* ffe-TP (otherwise): a rank holds every expert's ``ffe / tp`` slice and
  runs every kept slot on it.

The two entry points differ in their capacity rule.  ``moe_ffn`` keeps the
reference's global semantics over the data ranks (GSPMD sees the global
batch): ``N`` is the global token count, the loss-free branch is taken iff
``N * K <= 4096``, a choice's rank within its expert counts that expert's
choices on lower data ranks (one ``all_gather`` of the ``[E]`` counts; the
global batch's rows are the data ranks' rows in order and the sort is
stable), and the load-balance loss and the overflow are global.
``moe_ffn_ep`` keeps the reference's shard_map rule: C from this data
rank's tokens, ``max(N_l * K * cf // E, K)``, no loss-free branch, the
overflow summed and the loss averaged over the data ranks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.distributed import (all_gather, all_reduce,
                                          all_reduce_both_ways,
                                          copy_to_group, reduce_from_group)
from repro_torch.models.layers import COMPUTE_DTYPE, Init, Params
from repro_torch.sharding.specs import (bound_axis, current_binding,
                                        model_axis, shard_hint)

LOSS_FREE_SLOTS = 4096   # N * K at or below: capacity N * K, nothing drops


def init_moe(init: Init, cfg) -> Params:
    m = cfg.moe
    d, ffe, E = cfg.d_model, m.d_ff_expert, m.num_experts
    p = {
        "router": init.dense((d, E)),
        "wg": init.dense((E, d, ffe), in_axis=1),
        "wu": init.dense((E, d, ffe), in_axis=1),
        "wd": init.dense((E, ffe, d), in_axis=1),
    }
    if m.num_shared:
        ff_sh = m.num_shared * ffe
        p["shared"] = Params(wg=init.dense((d, ff_sh)),
                             wu=init.dense((d, ff_sh)),
                             wd=init.dense((ff_sh, d)))
    return Params(**p)


def route(p, xf, cfg):
    """The float32 router: (probs [N, E], top-k weights [N, K], top-k
    experts [N, K] int64), the weights renormalised after top-k."""
    m = cfg.moe
    logits = (xf @ p["router"].to(COMPUTE_DTYPE)).float()          # [N, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, m.top_k, dim=-1)              # [N, K]
    if m.router_softmax_after_topk:
        top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    return probs, top_p, top_e


def moe_ffn(p, x, cfg):
    """x [B, T, d] -> (y [B, T, d], aux dict with load-balance loss).
    Under a binding, the global semantics over the data ranks (module
    docstring)."""
    return _dispatch(p, x, cfg, ep_rule=False)


def moe_ffn_ep(p, x, cfg):
    """The expert-parallel dispatch with the reference's shard_map
    capacity rule (module docstring); ``moe_ffn`` outside a binding with a
    ``model`` dim, as in the reference."""
    bind = current_binding()
    if bind is None or "model" not in bind[0].mesh_dim_names:
        return moe_ffn(p, x, cfg)
    return _dispatch(p, x, cfg, ep_rule=True)


def _stats(probs, top_e, N: int, E: int, K: int, cfg, ep_rule: bool):
    """(C, each choice's rank offset by expert [E], aux loss, overflow) of
    this data rank's routing under the capacity rule."""
    m = cfg.moe
    data = bound_axis("data")
    dev = probs.device
    counts = torch.zeros(E, dtype=torch.int64, device=dev).index_add_(
        0, top_e.reshape(-1), torch.ones(N * K, dtype=torch.int64,
                                         device=dev))
    if ep_rule:
        C = max(int(N * K * m.capacity_factor) // E, K)
        ce = counts.float() / (N * K)
        aux = E * torch.sum(torch.mean(probs, dim=0) * ce)
        overflow = torch.clamp(counts - C, min=0).sum()
        if data is not None:
            aux = all_reduce_both_ways(aux, data.group, "moe_stats") \
                / data.size
            overflow = all_reduce(overflow, data.group, "moe_stats")
        return C, None, aux, overflow
    n_glob = N * (1 if data is None else data.size)
    if n_glob * K <= LOSS_FREE_SLOTS:
        C = n_glob * K
    else:
        C = max(int(n_glob * K * m.capacity_factor) // E, 1)
    if data is None:
        me = torch.mean(probs, dim=0)
        offset, total = None, counts
    else:
        every = all_gather(counts, current_binding()[0], "data")    # [dp, E]
        offset, total = every[:data.rank].sum(0), every.sum(0)
        me = all_reduce_both_ways(probs.sum(0), data.group,
                                  "moe_stats") / n_glob
    ce = total.float() / (n_glob * K)
    aux = E * torch.sum(me * ce)
    overflow = torch.clamp(total - C, min=0).sum()
    return C, offset, aux, overflow


def _dispatch(p, x, cfg, *, ep_rule: bool):
    m = cfg.moe
    B, T, d = x.shape
    E, K, ffe = m.num_experts, m.top_k, m.d_ff_expert
    N = B * T
    xf = x.reshape(N, d)
    c = COMPUTE_DTYPE
    dev = x.device
    # the experts this rank holds: a block of E_l (block-EP), or all of
    # them whole or as ffe slices (ffe-TP)
    E_l = p["wg"].shape[0]
    split = E_l < E or p["wg"].shape[2] < ffe
    model = model_axis() if split else bound_axis("model")
    if model is not None and not split:
        raise ValueError(f"{cfg.name}: neither E={E} nor ffe={ffe} divides "
                         f"tp={model.size}")
    group = None if model is None else model.group
    base = model.rank * E_l if E_l < E else 0

    probs, top_p, top_e = route(p, xf, cfg)
    C, offset, aux_loss, overflow = _stats(probs, top_e, N, E, K, cfg,
                                           ep_rule)

    # --- sort-based dispatch (static shapes) ---
    e_flat = top_e.reshape(-1)                                     # [N*K]
    w_flat = copy_to_group(top_p, group).reshape(-1).to(c)
    t_flat = torch.arange(N * K, device=dev) // K                  # token ids
    e_loc = e_flat - base
    mine = (e_loc >= 0) & (e_loc < E_l)
    e_loc = torch.where(mine, e_loc, E_l)                          # drop -> E_l
    order = torch.argsort(e_loc, stable=True)
    e_s, w_s, t_s = e_loc[order], w_flat[order], t_flat[order]
    pos = torch.arange(N * K, device=dev)
    is_start = torch.ones_like(e_s, dtype=torch.bool)
    is_start[1:] = e_s[1:] != e_s[:-1]
    rank = pos - torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    g_rank = rank if offset is None else rank + offset[e_flat[order]]
    ok = (e_s < E_l) & (g_rank < C)
    slot = torch.where(ok, e_s * C + rank, E_l * C)          # drop -> E_l*C

    tok_for_slot = torch.full((E_l * C + 1,), N, dtype=torch.int64, device=dev)
    tok_for_slot[slot] = t_s
    tok_for_slot = tok_for_slot[:-1]
    w_for_slot = torch.zeros((E_l * C + 1,), dtype=c, device=dev)
    w_for_slot[slot] = w_s
    w_for_slot = w_for_slot[:-1]

    xin = copy_to_group(xf, group)
    xpad = torch.cat([xin, torch.zeros((1, d), dtype=xf.dtype, device=dev)])
    xs = xpad[tok_for_slot].reshape(E_l, C, d)                     # [E_l, C, d]
    xs = shard_hint(xs, ("expert", None, None), (E, C, d))

    h = F.silu(torch.bmm(xs, p["wg"].to(c))) * torch.bmm(xs, p["wu"].to(c))
    ys = torch.bmm(h, p["wd"].to(c))                               # [E_l, C, d]
    ys = shard_hint(ys, ("expert", None, None), (E, C, d))

    ys_flat = ys.reshape(E_l * C, d) * w_for_slot[:, None]
    y = torch.zeros((N + 1, d), dtype=c, device=dev).index_add_(
        0, tok_for_slot, ys_flat)[:N]

    shared = None
    if m.num_shared:
        sp = p["shared"]
        sh_split = sp["wd"].shape[0] < m.num_shared * ffe
        xs_in = xin if sh_split else xf
        shared = (F.silu(xs_in @ sp["wg"].to(c)) *
                  (xs_in @ sp["wu"].to(c))) @ sp["wd"].to(c)
        if sh_split:               # a partial sum too: into the one reduce
            y, shared = y + shared, None
    y = reduce_from_group(y, group)
    if shared is not None:
        y = y + shared
    return y.reshape(B, T, d), {"moe_aux_loss": aux_loss,
                                "moe_overflow": overflow}
