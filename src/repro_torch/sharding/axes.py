"""Parameters and caches -> logical axes, by name and rank: the port of the
JAX package's ``sharding/axes.py``.

Both functions return ``{dotted path in the reference's layout: logical
axes}`` (the stacks stacked, as ``models/convert.stack_tree`` lays them
out), the tuples the reference's trees hold at those paths.  They read
names and shapes only, so a ``Model`` on the ``meta`` device serves.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.convert import is_stacked, reference_groups

# last key -> logical axes (without any leading stack dims)
_BY_NAME: dict = {
    "embed": ("vocab", "embed"),
    "head": ("embed", "vocab"),
    "img_proj": (None, "embed"),
    "frame_proj": (None, "embed"),
    "wq": ("embed", "heads"),
    "wk": ("embed", "kv_heads"),
    "wv": ("embed", "kv_heads"),
    "wo": ("heads", "embed"),
    "bq": ("heads",),
    "bk": ("kv_heads",),
    "bv": ("kv_heads",),
    "wg": ("embed", "ff"),
    "wu": ("embed", "ff"),
    "wd": ("ff", "embed"),
    "bu": ("ff",),
    "bd": ("embed",),
    "router": ("embed", None),
    # mamba
    "in_proj": ("embed", "d_inner"),
    "conv_w": (None, "d_inner"),
    "conv_b": ("d_inner",),
    "x_proj": ("d_inner", None),
    "dt_proj": (None, "d_inner"),
    "dt_bias": ("d_inner",),
    "A_log": ("d_inner", None),
    "D": ("d_inner",),
    "out_proj": ("d_inner", "embed"),
    # rg-lru
    "in_y": ("embed", "lru"),
    "in_x": ("embed", "lru"),
    "wa": ("lru_blocks", None, None),
    "wx": ("lru_blocks", None, None),
    "lam": ("lru",),
    "out": ("lru", "embed"),
    # norms / misc: replicate
    "scale": (None,),
    "bias": (None,),
}

# keys under which the experts' 3D weights live (expert-sharded, EP)
_MOE_WEIGHTS = ("wg", "wu", "wd")

# last key -> the equal parts its sharded dim holds, each cut alike: Mamba's
# fused ``in_proj`` is ``[x | z]``, and a rank holds ``[x_r | z_r]`` (the
# reference's spec reads it as one dim, which would give x to the first
# half of the ranks and z to the second)
_PARTS = {"in_proj": 2}


def param_parts(name: str) -> int:
    """The parts of the port's parameter ``name``'s sharded dim."""
    return _PARTS.get(name.rsplit(".", 1)[-1], 1)


def param_axes(model, cfg=None) -> dict:
    """{reference path: logical axes} of every parameter of ``model``.

    With ``cfg`` the attention / expert dims carry their semantic quantum
    (head count / expert count); expert stacks shard the expert dim, or
    fall back to the per-expert FFN dim on the same mesh axis."""
    by_name = dict(_BY_NAME)
    if cfg is not None:
        H, Hk = ("heads", cfg.n_heads), ("kv_heads", cfg.n_kv_heads)
        by_name.update(wq=("embed", H), wo=(H, "embed"),
                       wk=("embed", Hk), wv=("embed", Hk),
                       bq=(H,), bk=(Hk,), bv=(Hk,))
    E = ("expert", cfg.moe.num_experts) if (cfg and cfg.moe) else "expert"
    shapes = {n: p.shape for n, p in model.named_parameters()}
    out = {}
    for path, group in reference_groups(shapes).items():
        ndim = len(shapes[group[0]]) + is_stacked(group[0])
        names = path.split(".")
        last = names[-1]
        if last in _MOE_WEIGHTS and any(n.startswith("ff_") for n in names) \
                and "shared" not in names and ndim >= 3:
            base: Tuple = (E, "ff", None) if last == "wd" \
                else (E, None, "ff")
        else:
            base = by_name.get(last, (None,) * ndim)
        out[path] = _lead(base, ndim)
    return out


def _lead(base: Tuple, ndim: int) -> Tuple:
    """``base`` with a ``layers`` axis for each leading stack dim."""
    extra = ndim - len(base)
    if extra > 0:
        return ("layers",) * extra + tuple(base)
    return tuple(base[-ndim:]) if ndim else ()


# decode-cache logical axes.  Every cache leaf carries a leading stacked-
# layers dim in the reference; the trailing dims map by name.
_CACHE_BY_NAME: dict = {
    "k": ("batch", "kv_seq", None, None),      # [B, S, Hk, hd]
    "v": ("batch", "kv_seq", None, None),
    "conv": ("batch", None, "d_inner"),        # [B, dc-1, width]
    # mamba [B, di, st] / rglru [B, lru]: "d_inner" for both, which holds
    # because "lru" and "d_inner" map to the same mesh axis (the model dim)
    "h": ("batch", "d_inner", None),
    "cross_k": ("batch", None, None, None),    # [B, F, Hk, hd]
    "cross_v": ("batch", None, None, None),
    "pos": ("batch",),
}


def cache_axes(cache) -> dict:
    """{reference path: logical axes} of a decode cache (``Model.
    init_cache`` or ``cache_shape``): the trunk's ``blocks.c_i.<field>``
    stacked over blocks and ``tail.c_i.<field>``, or whisper's
    ``self_kv.<field>``, ``cross_k`` and ``cross_v`` stacked over layers.
    As the reference, it puts ``layers`` before the unstacked tail's
    leaves too."""
    out = {}
    for path, t in cache_leaves(cache).items():
        keys = path.split(".")
        ndim = t.dim() + (keys[0] != "tail")
        ref = ".".join(k for k in keys if not k.isdigit())
        out[ref] = ("layers",) + cache_leaf_axes(path, ndim - 1)
    return out


def cache_leaves(cache) -> dict:
    """{port path: tensor} of a decode cache: ``blocks.<b>.c_<i>.<field>``
    and ``tail.c_<i>.<field>`` of the trunk's, ``self_kv.<l>.<field>``,
    ``cross_k.<l>`` and ``cross_v.<l>`` of whisper's."""
    out: dict = {}
    cache_map(cache, lambda path, t: out.setdefault(path, t))
    return out


def cache_map(cache, fn, kv=None):
    """``cache`` rebuilt with each tensor ``t`` at port path ``path``
    replaced by ``fn(path, t)``, and, where ``kv`` is given, each rebuilt
    attention cache ``c`` (``layers.KVCache``: the node with a ``seq``
    field) at ``path`` by ``kv(path, c)``.  Other fields pass through."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}{k}.") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}{i}.") for i, v in enumerate(node)]
        if isinstance(node, tuple):
            out = type(node)(*[walk(v, f"{path}{f}.")
                               for f, v in zip(node._fields, node)])
            if kv is not None and "seq" in node._fields:
                return kv(path[:-1], out)
            return out
        if isinstance(node, torch.Tensor):
            return fn(path[:-1], node)
        return node
    return walk(cache, "")


def cache_leaf_axes(path: str, ndim: int) -> Tuple:
    """The logical axes of the port's cache leaf at ``path`` (of rank
    ``ndim``): the reference's ``cache_axes`` less the stack dim.  The
    reference also puts ``layers`` before the unstacked tail's leaves,
    which names each of their dims by its neighbour's; the port names them
    as the stacked leaves."""
    field = next(k for k in reversed(path.split(".")) if not k.isdigit())
    return tuple(_CACHE_BY_NAME.get(field, (None,) * ndim)[:ndim])
