"""Rank functions of the port's training tests: torch and ``repro_torch``
only, so that ranks spawned by ``torch_dist.spawn`` never load JAX.  Each
returns plain Python values and numpy arrays."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed import COMM
from repro_torch.launch.train import make_batch_fn
from repro_torch.models import Model
from repro_torch.optim.compress import ef_compress_grads
from repro_torch.runtime.checkpoint import latest_step, save_checkpoint
from repro_torch.runtime.fault import elastic_restore
from repro_torch.runtime.train import (load_train_state, make_train_step,
                                       train_state_init, train_state_tree)
from repro_torch.sharding.specs import logical_rules


@contextlib.contextmanager
def compute_dtype(dtype):
    """The port's model stack computes in ``dtype`` (its modules'
    ``COMPUTE_DTYPE``, and the KV cache's dtype, a default bound when
    ``init_kv_cache`` is defined), restored on exit."""
    from repro_torch.models import layers, moe, rglru, ssm
    mods = (layers, moe, ssm, rglru)
    saved = [m.COMPUTE_DTYPE for m in mods]
    kv = layers.init_kv_cache.__defaults__
    for m in mods:
        m.COMPUTE_DTYPE = dtype
    layers.init_kv_cache.__defaults__ = (dtype,) + kv[1:]
    try:
        yield
    finally:
        for m, d in zip(mods, saved):
            m.COMPUTE_DTYPE = d
        layers.init_kv_cache.__defaults__ = kv


def train_span(mesh, dev, cfg, first: int, last: int, total: int,
               batch: int, seq: int, compress: bool = False,
               ckpt_dir=None, float32: bool = False, rules=None,
               zero1: bool = False) -> dict:
    """As ``_train_span``, in float32 compute when ``float32``, under
    ``logical_rules(mesh, rules)`` on a mesh (an MoE's capacity is then the
    global batch's; the ``seq`` rule runs the model sequence parallel)."""
    with compute_dtype(torch.float32) if float32 else \
            contextlib.nullcontext(), logical_rules(mesh, rules) \
            if mesh is not None else contextlib.nullcontext():
        return _train_span(mesh, dev, cfg, first, last, total, batch, seq,
                           compress, ckpt_dir, rules, zero1)


def _train_span(mesh, dev, cfg, first: int, last: int, total: int,
                batch: int, seq: int, compress: bool = False,
                ckpt_dir=None, rules=None, zero1: bool = False) -> dict:
    """Steps [first, last) of a run of ``total`` steps of ``cfg`` (weights
    from seed 0) on this rank's rows of the global ``lm_batch``; with
    ``mesh`` None, one process on the whole batch.  From ``ckpt_dir``'s
    newest checkpoint when ``first`` > 0; rank 0 writes one at ``last``.
    Returns the losses, the final params and residuals (numpy, by name),
    the whole moments (``m``, ``v``, by name), this rank's slots' bytes,
    its ``COMM`` meters of the steps and the step it started from.  On a
    mesh whose ``model`` dim holds more than one rank the model is cut over
    it (``shard_params``) and the params come back gathered.  ``zero1`` cuts
    the slots over the data dim; then the result also holds the largest
    difference between this rank's slots and the whole moments cut by
    ``shard_of`` under ``slot_specs``."""
    from repro_torch.models.convert import unstack_tree
    from repro_torch.sharding.specs import (gather_params, shard_of,
                                            shard_params, slot_specs)
    torch.set_num_threads(1)
    group = None if mesh is None else mesh.get_group("data")
    rank = 0 if group is None else dist.get_rank(group)
    world = 1 if group is None else dist.get_world_size(group)
    tp = 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index("model"))
    model = Model(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(0))
    kw = {"compress_group" if compress else "data_group": group} \
        if group is not None else {}
    if tp > 1:
        shard_params(model, mesh)
        kw["model_group"] = mesh.get_group("model")
    step = make_train_step(model, total_steps=total, warmup=2, zero1=zero1,
                           **kw)
    state = train_state_init(model, compress=compress, zero1=zero1,
                             data_group=group)
    start = 0
    if first:
        tree, start, _ = elastic_restore(
            ckpt_dir, train_state_tree(state, model), device="cpu")
        state = load_train_state(tree, model)
    batch_fn = make_batch_fn(cfg, batch, seq, device=dev, rank=rank,
                             world=world)
    COMM.reset()
    losses, overflow = [], []
    for i in range(start, last):
        state, m = step(state, batch_fn(i))
        losses.append(float(m["loss"]))
        overflow.append(float(m.get("moe_overflow", 0.0)))
    comm = COMM.snapshot()
    lead = mesh is None or dist.get_rank() == 0
    tree = train_state_tree(state, model)   # every rank: it gathers
    if ckpt_dir is not None and lead:
        save_checkpoint(ckpt_dir, last, tree)
    params = state.params if tp == 1 else gather_params(state.params,
                                                         model.sharding)
    ef = state.ef_error or {}
    moments = {f: {k: t.numpy() for k, t in unstack_tree(
        getattr(tree.opt, f)).items()} for f in ("m", "v")}
    out = {"losses": losses, "overflow": overflow, "start": start,
           "params": {k: p.detach().cpu().numpy()
                      for k, p in params.items()}, **moments,
           "ef_abs": float(sum(e.abs().sum() for e in ef.values())),
           "comm": comm, "written": latest_step(ckpt_dir)
           if ckpt_dir is not None else None,
           "slot_bytes": sum(t.numel() * t.element_size()
                             for f in (state.opt.m, state.opt.v)
                             for t in f.values())}
    if zero1:
        specs = slot_specs(model, mesh, rules)
        parts = model.sharding.parts_of if tp > 1 else (lambda k: 1)
        out["slot_err"] = max(float((shard_of(torch.from_numpy(
            moments["m"][k]), specs[k], mesh, parts(k)) - t.cpu()).abs()
            .max()) for k, t in state.opt.m.items())
    return out


def zero1_adamw_rank(mesh, dev, cases: list) -> list:
    """ZeRO-1 AdamW over the data group, per case ``(params, axes, grads)``
    (numpy leaves, their logical axes, and a list over updates of a list
    over ranks of numpy grads): the slots cut by ``spec_for`` of ``axes``
    under ``ZERO1_RULES`` over a data dim of the group's ranks; each update
    takes this rank's grads to the mean's slices (``scatter_grads``, the
    uncut leaves all_reduced) and runs ``adamw_update``.  Per case and
    update: the params, the gathered ``m`` and ``v``, the grad norm and the
    lr; per case the slots' shapes."""
    from repro_torch.core.distributed import all_reduce
    from repro_torch.optim import adamw as TA
    from repro_torch.sharding.specs import (DEFAULT_RULES, ZERO1_RULES,
                                            data_dim, spec_for)
    torch.set_num_threads(1)
    group = mesh.get_group("data")
    k, r = dist.get_world_size(group), dist.get_rank(group)
    rules = {**DEFAULT_RULES, **ZERO1_RULES}
    out = []
    for params, axes, grads in cases:
        dims = {n: data_dim(spec_for(axes[n], v.shape, {"data": k}, rules))
                for n, v in params.items()}
        zero1 = TA.Zero1({n: d for n, d in dims.items() if d is not None},
                         group, r, k)
        p = {n: torch.from_numpy(v.copy()).to(dev) for n, v in params.items()}
        state = TA.adamw_init(p, zero1)
        shapes = {n: tuple(t.shape) for n, t in state.m.items()}
        steps = []
        for g in grads:
            mine = {n: torch.from_numpy(v).to(dev) for n, v in g[r].items()}
            cut = TA.scatter_grads({n: mine[n] for n in zero1.dims}, zero1)
            rest = {n: all_reduce(t, group) / k for n, t in mine.items()
                    if n not in zero1.dims}
            p, state, met = TA.adamw_update(
                p, {**rest, **cut}, state,
                lr_fn=TA.cosine_schedule(1e-2, 1, 10), zero1=zero1)
            steps.append({
                "params": {n: t.cpu().numpy().copy() for n, t in p.items()},
                "m": {n: t.cpu().numpy().copy() for n, t in
                      zero1.whole(state.m).items()},
                "v": {n: t.cpu().numpy().copy() for n, t in
                      zero1.whole(state.v).items()},
                "grad_norm": float(met["grad_norm"]),
                "lr": float(met["lr"])})
        out.append({"slots": shapes, "steps": steps})
    return out


def ef_rank(mesh, dev, grads: list, errors: list) -> tuple:
    """``ef_compress_grads`` of this rank's ``grads[rank]`` with residuals
    ``errors[rank]`` (dicts of numpy arrays) over the data group."""
    group = mesh.get_group("data")
    r = dist.get_rank(group)

    def t(d):
        return {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
    out, new_e = ef_compress_grads(t(grads[r]), t(errors[r]), group)
    return ({k: v.cpu().numpy() for k, v in out.items()},
            {k: v.cpu().numpy() for k, v in new_e.items()})


def f16_mean(payloads: list) -> np.ndarray:
    """The reference's float16 psum of the ranks' payloads, divided by
    their count in float32 (gloo sums in rank order)."""
    acc = payloads[0]
    for p in payloads[1:]:
        acc = (acc + p).astype(np.float16)
    return acc.astype(np.float32) / np.float32(len(payloads))


def tp_rank(mesh, dev, cases, rules=None) -> list:
    """Per case ``(cfg, tree, batch)`` (the JAX package's weights and a
    batch, numpy), the model cut over this rank's ``model`` dim
    (``params_from_jax(mesh=)``) in float32 compute under
    ``logical_rules``, on this data rank's rows of the batch: the gathered
    logits of those rows, the loss metrics and the grads (averaged over
    the data dim: the whole batch's) gathered to the reference's layout,
    this rank's shard shapes, its Mamba ``in_proj`` shards and its
    replicated leaves' grads, the collective census of the loss and its
    backward, and the grad norm of one clipped train step.  ``rules``
    bind over the default ones (the ``seq`` rule: sequence
    parallelism)."""
    from repro_torch.core.distributed import all_reduce
    from repro_torch.models.convert import flatten, params_from_jax, stack_tree
    from repro_torch.sharding.specs import gather_params
    torch.set_num_threads(1)
    dp = mesh.size(mesh.mesh_dim_names.index("data"))
    data = mesh.get_group("data") if dp > 1 else None
    out = []
    with compute_dtype(torch.float32), logical_rules(mesh, rules):
        for cfg, tree, nb in cases:
            model = params_from_jax(cfg, tree, device=dev, mesh=mesh)
            specs = model.sharding.specs
            B = len(nb["tokens"])
            r = 0 if data is None else dist.get_rank(data)
            b = {k: torch.from_numpy(v[r * B // dp:(r + 1) * B // dp]).to(dev)
                 for k, v in nb.items()}
            with torch.no_grad():
                logits, _ = model.forward(b, gather=True)
            COMM.reset()
            loss, met = model.loss(b)
            loss.backward()
            census = COMM.census()
            local = {k: p.grad.detach().clone()
                     for k, p in model.named_parameters()}
            met = {k: v.detach() for k, v in met.items()}
            if data is not None:
                local = {k: all_reduce(g, data) / dp for k, g in local.items()}
                met = {k: all_reduce(v, data) / dp for k, v in met.items()}
            whole = stack_tree(gather_params(local, model.sharding))
            in_proj = {k: p.detach().cpu().numpy().copy()
                       for k, p in model.named_parameters()
                       if k.endswith("in_proj")}
            step = make_train_step(model, total_steps=4, warmup=2,
                                   data_group=data,
                                   model_group=mesh.get_group("model"))
            _, m = step(train_state_init(model), b)
            out.append({
                "logits": logits.cpu().numpy(),
                "metrics": {k: float(v) for k, v in met.items()},
                "grads": {k: v.numpy() for k, v in flatten(whole)},
                "shapes": {k: tuple(p.shape)
                           for k, p in model.named_parameters()},
                "in_proj": in_proj,
                "replicated": {k: g.cpu().numpy() for k, g in local.items()
                               if all(a is None for a in specs[k])},
                "census": census,
                "grad_norm": float(m["grad_norm"])})
    return out


def tp_decode_rank(mesh, dev, cases) -> list:
    """Per case ``(cfg, tree, tokens, frames, max_seq, cache)``: the model
    cut over this rank's ``model`` dim, in float32 compute under
    ``logical_rules``; ``init_cache``'s local shapes (and their whole
    shapes by ``cache_shape`` outside the binding); the whole ``cache``
    (numpy, by port path: a prefix already decoded) cut to this rank's
    shard by ``shard_cache``, decoding this data rank's rows of ``tokens``
    [B, steps] a step at a time: the gathered logits, the local shapes and
    ``pos`` after the steps, each attention cache's ``seq`` mark (fresh and
    after the steps) and the gathered cache (numpy by path)."""
    from repro_torch.models.convert import params_from_jax
    from repro_torch.sharding.axes import cache_leaves, cache_map
    from repro_torch.sharding.specs import (cache_sharding, gather_cache,
                                            shard_cache)
    torch.set_num_threads(1)
    dp = mesh.size(mesh.mesh_dim_names.index("data"))
    r = mesh.get_local_rank("data")
    out = []

    def marks(cache):
        seq = {}

        def note(path, c):
            seq[path] = c.seq
            return c
        cache_map(cache, lambda path, t: t, note)
        return seq
    with compute_dtype(torch.float32):
        for cfg, tree, tokens, frames, max_seq, whole in cases:
            B = tokens.shape[0]
            rows = slice(r * B // dp, (r + 1) * B // dp)
            with logical_rules(mesh):
                model = params_from_jax(cfg, tree, device=dev, mesh=mesh)
            f = None if frames is None else torch.from_numpy(
                frames[rows]).to(dev)
            empty = model.cache_shape(B, max_seq)
            with logical_rules(mesh):
                fresh = model.init_cache(B, max_seq, f)
                cache = cache_map(empty, lambda path, t: torch.from_numpy(
                    whole[path]).to(dev))
                cut = cache_sharding(cache, mesh)
                cache = shard_cache(cache, mesh)
                logits = []
                for t in range(tokens.shape[1]):
                    lt, cache = model.decode_step(
                        torch.from_numpy(tokens[rows, t]).to(dev), cache)
                    logits.append(lt.cpu().numpy())
                gathered = gather_cache(cache, cut)
            out.append({
                "rows": (rows.start, rows.stop),
                "logits": np.stack(logits, 1),
                "fresh": {k: (tuple(t.shape), str(t.dtype)) for k, t in
                          cache_leaves(fresh).items()},
                "whole": {k: tuple(t.shape) for k, t in
                          cache_leaves(empty).items()},
                "local": {k: tuple(t.shape) for k, t in
                          cache_leaves(cache).items()},
                "seq": (marks(fresh), marks(cache)),
                "cross": [t.cpu().numpy() for t in fresh.cross_k]
                if cfg.is_encdec else None,
                "cache": {k: t.float().cpu().numpy() for k, t in
                          cache_leaves(gathered).items()}})
    return out


def moe_config(experts: int, cf: float):
    """The reduced qwen2-moe config of ``tests/torch_moe_ep_jax.py``."""
    import dataclasses

    from repro_torch.models import ARCHS
    cfg = ARCHS["qwen2-moe-a2.7b"].reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=experts, capacity_factor=cf))


def moe_ep_rank(mesh, dev, cases) -> list:
    """Per case ``(npz path, (data, model), experts, capacity factor)``:
    the case's weights cut to this rank's shards by ``spec_for`` (the
    reference's logical axes of an MoE layer), and ``moe_ffn_ep`` and
    ``moe_ffn`` on this data rank's rows of its ``x``, in float32 compute
    under ``logical_rules`` of a mesh of that shape over the same ranks."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.layers import Params
    from repro_torch.sharding.specs import shard_of, spec_for
    torch.set_num_threads(1)
    meshes = {tuple(mesh.shape): mesh}
    out = []
    for path, shape, experts, cf in cases:
        m = meshes.get(tuple(shape))
        if m is None:
            m = meshes[tuple(shape)] = make_host_mesh(*shape)
        cfg = moe_config(experts, cf)
        data = np.load(path)
        E = ("expert", experts)
        axes = {"router": ("embed", None), "wg": (E, None, "ff"),
                "wu": (E, None, "ff"), "wd": (E, "ff", None),
                "shared.wg": ("embed", "ff"), "shared.wu": ("embed", "ff"),
                "shared.wd": ("ff", "embed")}
        w, specs = {}, {}
        for k, names in axes.items():
            t = torch.from_numpy(data["w." + k])
            specs[k] = spec_for(names, t.shape, m)
            w[k] = shard_of(t, specs[k], m).clone().to(dev)
        p = Params(router=w["router"], wg=w["wg"], wu=w["wu"], wd=w["wd"],
                   shared=Params(**{k: w["shared." + k]
                                    for k in ("wg", "wu", "wd")}))
        x = torch.from_numpy(data["x"])
        dp, r = shape[0], m.get_local_rank("data")
        rows = (r * x.shape[0] // dp, (r + 1) * x.shape[0] // dp)
        xl = x[rows[0]:rows[1]].to(dev)
        with compute_dtype(torch.float32), logical_rules(m), \
                torch.no_grad():
            y_ep, a_ep = M.moe_ffn_ep(p, xl, cfg)
            y, a = M.moe_ffn(p, xl, cfg)
        out.append({"rows": rows, "specs": specs,
                    "shapes": {k: tuple(v.shape) for k, v in w.items()},
                    "y_ep": y_ep.cpu().numpy(),
                    "aux_ep": float(a_ep["moe_aux_loss"]),
                    "ovf_ep": int(a_ep["moe_overflow"]),
                    "y": y.cpu().numpy(), "aux": float(a["moe_aux_loss"]),
                    "ovf": int(a["moe_overflow"])})
    return out
