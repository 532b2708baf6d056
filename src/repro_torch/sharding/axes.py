"""Parameters and caches -> logical axes, by name and rank: the port of the
JAX package's ``sharding/axes.py``.

Both functions return ``{dotted path in the reference's layout: logical
axes}`` (the stacks stacked, as ``models/convert.stack_tree`` lays them
out), the tuples the reference's trees hold at those paths.  They read
names and shapes only, so a ``Model`` on the ``meta`` device serves.
"""

from __future__ import annotations

from typing import Tuple

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
    "h": ("batch", "d_inner", None),           # mamba [B, di, st] / rglru [B, lru]
    "cross_k": ("batch", None, None, None),    # [B, F, Hk, hd]
    "cross_v": ("batch", None, None, None),
    "pos": ("batch",),
}


def cache_axes(cache) -> dict:
    """{reference path: logical axes} of a decode cache (``Model.
    init_cache`` or ``cache_shape``): the trunk's ``blocks.c_i.<field>``
    stacked over blocks and ``tail.c_i.<field>``, or whisper's
    ``self_kv.<field>``, ``cross_k`` and ``cross_v`` stacked over layers."""
    out = {}
    for path, ndim in _cache_ranks(cache).items():
        last = path.rsplit(".", 1)[-1]
        base = _CACHE_BY_NAME.get(last, (None,) * (ndim - 1))
        out[path] = ("layers",) + tuple(base[: ndim - 1])
    return out


def _cache_ranks(cache) -> dict:
    """{reference path: rank of the reference's leaf there}."""
    if isinstance(cache, dict):
        ranks = {}
        for key, per_block in (("blocks", cache["blocks"][0]),
                               ("tail", cache.get("tail"))):
            stacked = key == "blocks"
            for ci, nt in (per_block or {}).items():
                for field, t in zip(nt._fields, nt):
                    ranks[f"{key}.{ci}.{field}"] = t.dim() + stacked
        return ranks
    ranks = {f"self_kv.{f}": t.dim() + 1
             for f, t in zip(cache.self_kv[0]._fields, cache.self_kv[0])}
    ranks["cross_k"] = cache.cross_k[0].dim() + 1
    ranks["cross_v"] = cache.cross_v[0].dim() + 1
    return ranks
