"""Mixture-of-Experts feed-forward (moonshot 64e/top-6+2sh, qwen2-moe
60e/top-4+4sh): the port of the JAX package's ``moe_ffn``.

Sort-based capacity dispatch: flatten (token, choice) pairs, sort by expert
(stably), rank within expert runs, drop beyond the static capacity
C = ceil(T * top_k / E * capacity_factor), gather tokens into [E, C, d]
buckets, run the expert FFNs as one batched matmul, scatter-add back with the
router weights.  Capacity overflow is counted and returned (aux).

The reference's shard_map dispatch over a mesh (``moe_ffn_ep``) and its
``shard_hint`` layout hints wait for the port's sharding slice; no config
selects the former by default (``moe_impl="gspmd"``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import COMPUTE_DTYPE, Init, Params


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
    """x [B, T, d] -> (y [B, T, d], aux dict with load-balance loss)."""
    m = cfg.moe
    B, T, d = x.shape
    E, K = m.num_experts, m.top_k
    N = B * T
    xf = x.reshape(N, d)
    c = COMPUTE_DTYPE
    dev = x.device

    probs, top_p, top_e = route(p, xf, cfg)

    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    me = torch.mean(probs, dim=0)                                  # [E]
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, top_e.reshape(-1), torch.ones(N * K, device=dev)) / (N * K)
    aux_loss = E * torch.sum(me * ce)

    # --- sort-based dispatch (static shapes) ---
    # decode-sized batches (N*K small) get loss-free capacity: a dropped
    # token in a 1-token decode step is a wrong answer, not a regularizer.
    if N * K <= 4096:
        C = N * K
    else:
        C = max(int(N * K * m.capacity_factor) // E, 1)
    e_flat = top_e.reshape(-1)                                     # [N*K]
    w_flat = top_p.reshape(-1).to(c)
    t_flat = torch.arange(N * K, device=dev) // K                  # token ids
    order = torch.argsort(e_flat, stable=True)
    e_s, w_s, t_s = e_flat[order], w_flat[order], t_flat[order]
    pos = torch.arange(N * K, device=dev)
    is_start = torch.ones_like(e_s, dtype=torch.bool)
    is_start[1:] = e_s[1:] != e_s[:-1]
    rank = pos - torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    ok = rank < C
    slot = torch.where(ok, e_s * C + rank, E * C)                  # drop -> E*C
    overflow = torch.sum(~ok)

    tok_for_slot = torch.full((E * C + 1,), N, dtype=torch.int64, device=dev)
    tok_for_slot[slot] = t_s
    tok_for_slot = tok_for_slot[:-1]
    w_for_slot = torch.zeros((E * C + 1,), dtype=c, device=dev)
    w_for_slot[slot] = w_s
    w_for_slot = w_for_slot[:-1]

    xpad = torch.cat([xf, torch.zeros((1, d), dtype=xf.dtype, device=dev)])
    xs = xpad[tok_for_slot].reshape(E, C, d)                       # [E, C, d]

    h = F.silu(torch.bmm(xs, p["wg"].to(c))) * torch.bmm(xs, p["wu"].to(c))
    ys = torch.bmm(h, p["wd"].to(c))                               # [E, C, d]

    ys_flat = ys.reshape(E * C, d) * w_for_slot[:, None]
    y = torch.zeros((N + 1, d), dtype=c, device=dev).index_add_(
        0, tok_for_slot, ys_flat)[:N]

    if m.num_shared:
        sp = p["shared"]
        y = y + (F.silu(xf @ sp["wg"].to(c)) *
                 (xf @ sp["wu"].to(c))) @ sp["wd"].to(c)
    return y.reshape(B, T, d), {"moe_aux_loss": aux_loss,
                                "moe_overflow": overflow}
