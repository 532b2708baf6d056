"""Logical-axis sharding: the port of the JAX package's ``sharding/specs.py``
(its rules table, divisibility-aware spec construction and thread-local
binding) and what the reference leaves to GSPMD: cutting parameters into
their local shards and gathering them back.

``spec_for`` maps a tensor's logical axis names to mesh axis names over a
mesh given as ``{axis name: size}`` (:func:`mesh_dims` of a ``DeviceMesh``),
and returns the tuple the reference's ``PartitionSpec`` holds: a mesh axis,
a tuple of them, or None (replicated) per dim.

``logical_rules(mesh)`` binds a ``DeviceMesh`` (dims ``"data"`` and
``"model"``) and the rules for this thread.  Under a binding the model
stack runs tensor and expert parallel over the ``model`` dim with explicit
local shards and named collectives (PyTorch has no GSPMD to propagate
layouts): a parameter is held as the shard :func:`shard_params` cut, and an
activation is this data rank's rows, whole over ``model`` unless a hint
says otherwise.  ``shard_hint`` checks that layout where the reference
constrains it.  Outside a binding everything runs on one device, as before.

Where the rules cut ``seq`` over ``model`` (a config's ``rules``) and the
sequence divides, the stack runs sequence parallel instead of holding
activations whole (:func:`seq_axis`, ``models/layers.py``).

ZeRO-1 (``ZERO1_RULES``, :func:`slot_specs`) lays AdamW's moments out as
their parameters, with the ``embed`` dim also cut over ``data``; a rank
holds its ``data`` slice of its ``model`` shard (:func:`data_dim`).

``shard_cache`` / ``gather_cache`` are the decode cache's counterparts of
``shard_params`` / ``gather_params``: each leaf is cut by ``spec_for`` of
its logical axes (``axes.cache_leaf_axes``: ``k``/``v`` over ``kv_seq``,
the recurrent states over their channels), and an attention cache whose
positions are cut says so (``layers.KVCache.seq``), which decode reads.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import NamedTuple, Optional, Sequence

import torch

# logical axis -> mesh axis (or tuple of mesh axes). None = replicate.
DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),     # DP over pod x data
    "seq": None,
    "kv_seq": "model",            # decode KV cache length
    "embed": None,
    "ff": "model",                # TP: MLP hidden
    "heads": "model",             # TP: attention q heads (fused H*hd dim)
    "kv_heads": "model",          # TP: kv heads (falls back when indivisible)
    "vocab": "model",             # TP: embedding/unembedding
    "expert": "model",            # EP: expert-sharded MoE weights
    "d_inner": "model",           # Mamba inner width
    "lru": "model",               # RG-LRU width
    "layers": None,               # stacked-block leading axis
    None: None,
}

DATA_AXES = ("pod", "data")

# ZeRO-1: the optimizer's slots (AdamW's m and v) cut their d_model dim over
# the data dim, on top of their parameter's layout (the JAX package's
# ``launch/dryrun.py`` ``ZERO1_RULES``)
ZERO1_RULES: dict = {"embed": "data"}

_ctx = threading.local()


def _mesh_size(mesh: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.get(a, 1)
        return n
    return mesh.get(axis, 1)


def mesh_dims(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (a dict passes through)."""
    if isinstance(mesh, dict):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_for(names: Sequence, shape: Sequence[int], mesh,
             rules: Optional[dict] = None) -> tuple:
    """The partition of a tensor from its logical names, dropping
    indivisible shardings (``rules`` default to ``DEFAULT_RULES``).

    An entry may be ``(name, quantum)``: the dim holds ``quantum`` semantic
    units (attention heads, experts) and only shards when whole units land
    per shard.  A mesh axis appears once per spec: its first use wins and
    later ones replicate."""
    mesh = mesh_dims(mesh)
    rules = DEFAULT_RULES if rules is None else rules
    parts = []
    for name, dim in zip(names, shape):
        quantum = None
        if isinstance(name, tuple):
            name, quantum = name
        axis = rules.get(name)
        if axis is not None and isinstance(axis, tuple):
            axis = tuple(a for a in axis if a in mesh) or None
        if axis is not None and not isinstance(axis, tuple) \
                and axis not in mesh:
            axis = None
        size = _mesh_size(mesh, axis)
        ok = (axis is not None and dim > 0 and dim % size == 0
              and (quantum is None or quantum % size == 0))
        parts.append(axis if ok else None)
    seen: set = set()
    out = []
    for p in parts:
        flat = p if isinstance(p, tuple) else (p,)
        if p is not None and any(a in seen for a in flat):
            out.append(None)
        else:
            out.append(p)
            seen.update(a for a in flat if a is not None)
    return tuple(out)


def is_axes_leaf(x) -> bool:
    """An axes leaf: a tuple of str | None | (str, int quantum)."""
    return isinstance(x, tuple) and all(
        isinstance(n, (str, type(None)))
        or (isinstance(n, tuple) and len(n) == 2 and isinstance(n[0], str))
        for n in x)


# --- the binding ------------------------------------------------------------

@contextmanager
def rebind(binding):
    """Run the block under ``binding`` (``current_binding()``'s value, None
    for none): what ``logical_rules`` sets, for code that runs on another
    thread, such as a remat block's recompute on autograd's thread."""
    prev = getattr(_ctx, "bind", None)
    _ctx.bind = binding
    try:
        yield
    finally:
        _ctx.bind = prev


def logical_rules(mesh, rules: Optional[dict] = None):
    """Bind (``mesh``, rules) for the model stack in this thread."""
    return rebind((mesh, {**DEFAULT_RULES, **(rules or {})}))


def current_binding():
    """The bound (mesh, rules), or None."""
    return getattr(_ctx, "bind", None)


class Axis(NamedTuple):
    """A bound mesh dim: its process group, this rank's index, its size."""
    group: object
    rank: int
    size: int


def bound_axis(name: str) -> Optional[Axis]:
    """The bound mesh's ``name`` dim (``"model"`` or ``"data"``); None
    outside a binding, or when the mesh has no such dim or it holds one
    rank.  On a mesh with a ``pod`` dim of more than one rank, ``"data"``
    is the pods' data ranks together (the ``batch`` rule's ``("pod",
    "data")``), one group flattened from the two dims."""
    bind = current_binding()
    if bind is None:
        return None
    mesh = bind[0]
    dims = mesh_dims(mesh)
    if name == "data" and dims.get("pod", 1) > 1:
        flat = mesh["pod", "data"]._flatten()
        return Axis(flat.get_group(), _index(dims, mesh, ("pod", "data")),
                    dims["pod"] * dims.get("data", 1))
    if dims.get(name, 1) == 1:
        return None
    return Axis(mesh.get_group(name), mesh.get_local_rank(name), dims[name])


def model_axis() -> Axis:
    """The bound ``model`` dim, for code that holds a shard: raises outside
    a binding whose ``model`` dim has more than one rank (a shard used
    alone would compute a part as if it were the whole)."""
    axis = bound_axis("model")
    if axis is None:
        raise RuntimeError("a sharded model runs under logical_rules(mesh) "
                           "with the mesh it was sharded over")
    return axis


def seq_axis(length: int) -> Optional[Axis]:
    """The bound ``model`` dim when the rules cut a sequence of ``length``
    positions over it (the ``seq`` rule, as ``spec_for`` lays ``("batch",
    "seq", "embed")``: a length it does not divide stays whole); None
    otherwise.  Under it the model stack runs sequence parallel
    (``models/layers.py``)."""
    bind = current_binding()
    if bind is None:
        return None
    mesh, rules = bind
    dims = {a: n for a, n in mesh_dims(mesh).items() if a not in DATA_AXES}
    cut = spec_for(("batch", "seq", "embed"), (1, length, 1), dims, rules)[1]
    if cut is None:
        return None
    if cut != "model":
        raise NotImplementedError(f"the seq rule cuts over {cut!r}; the "
                                  f"model stack cuts sequences over 'model'")
    return bound_axis("model")


def local_shape(spec: tuple, shape: Sequence[int], mesh) -> tuple:
    """The shape of one rank's shard of a ``shape`` tensor laid out by
    ``spec``."""
    dims = mesh_dims(mesh)
    return tuple(n // _mesh_size(dims, a) for a, n in zip(spec, shape))


def shard_hint(x: torch.Tensor, names: Sequence[Optional[str]],
               shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``x``, after checking it is the local shard over the bound mesh's
    model dims of a tensor of ``shape`` (``x``'s own by default: whole)
    that ``spec_for`` lays out by ``names``; the data dims do not count,
    since every activation is already this data rank's rows.  Where the
    reference constrains GSPMD's layout, the port checks its own.  A no-op
    outside a binding."""
    bind = current_binding()
    if bind is None:
        return x
    mesh, rules = bind
    dims = {a: n for a, n in mesh_dims(mesh).items() if a not in DATA_AXES}
    shape = tuple(x.shape) if shape is None else tuple(shape)
    want = local_shape(spec_for(names, shape, dims, rules), shape, dims)
    if tuple(x.shape) != want:
        raise ValueError(f"shard_hint {tuple(names)}: local shape "
                         f"{tuple(x.shape)}, the layout of {shape} over "
                         f"{dims} has {want}")
    return x


# --- parameters ---------------------------------------------------------------

class Sharding(NamedTuple):
    """How :func:`shard_params` (or :func:`shard_cache`) cut a model (a
    cache): the mesh, each leaf's spec (by the port's name; None entries
    replicate) and, for a leaf whose sharded dim holds equal parts cut
    alike (Mamba's ``in_proj``, ``[x | z]``), their count."""
    mesh: object
    specs: dict
    parts: Optional[dict] = None

    def parts_of(self, name: str) -> int:
        return (self.parts or {}).get(name, 1)


def param_specs(axes: dict, shapes: dict, mesh,
                rules: Optional[dict] = None) -> dict:
    """``{path: spec}`` from ``{path: logical axes}`` (``sharding.axes.
    param_axes``) and ``{path: shape}``, by ``spec_for`` (rules over
    ``DEFAULT_RULES``): the reference's ``param_specs`` without the
    ``NamedSharding`` wrapper."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    return {path: spec_for(names, shapes[path], mesh, rules)
            for path, names in axes.items()}


def model_specs(model, mesh, rules: Optional[dict] = None) -> dict:
    """Each of ``model``'s parameters' spec, by the port's name: the spec
    of the reference's leaf (the stacks stacked), less its stack dim.  A
    model already cut (``shard_params``) is laid out by its whole shapes.

    A stack's leading dim is its layers.  The reference's ``param_axes``
    names it so, except for a dense MLP's stacked ``wg``/``wu``/``wd``,
    whose rank (3) matches its expert-stack pattern: it calls the layer dim
    ``expert``, which shards it whenever the layer count divides the
    axis (and then leaves ``ff`` whole).  The port holds a layer a tensor
    and names that dim ``layers``, so such an MLP shards ``ff``."""
    from repro_torch.models.convert import is_stacked, reference_groups
    from repro_torch.sharding.axes import param_axes
    named = dict(model.named_parameters())
    groups = reference_groups(named)
    cut = getattr(model, "sharding", None)

    def whole(name: str) -> tuple:
        shape = tuple(named[name].shape)
        if cut is None:
            return shape
        dims = mesh_dims(cut.mesh)
        return tuple(n * _mesh_size(dims, a)
                     for n, a in zip(shape, cut.specs[name]))
    shapes = {path: ((len(g),) if is_stacked(g[0]) else ()) + whole(g[0])
              for path, g in groups.items()}
    axes = {path: ("layers",) + names[1:] if is_stacked(groups[path][0])
            else names for path, names in param_axes(model, model.cfg).items()}
    ref = param_specs(axes, shapes, mesh, rules)
    return {n: ref[path][1:] if is_stacked(n) else ref[path]
            for path, g in groups.items() for n in g}


def slot_specs(model, mesh, rules: Optional[dict] = None) -> dict:
    """Each parameter's ZeRO-1 slot spec (AdamW's ``m`` and ``v``), by the
    port's name: ``model_specs`` under ``rules`` with ``ZERO1_RULES`` over
    them, so a slot keeps its parameter's ``model`` cut and also cuts its
    ``embed`` dim over ``data`` where ``data`` divides it (and no other dim
    of the spec took ``data`` first)."""
    return model_specs(model, mesh, {**(rules or {}), **ZERO1_RULES})


def data_dim(spec: tuple) -> Optional[int]:
    """The dim ``spec`` cuts over the ``data`` mesh axis, or None."""
    return next((d for d, a in enumerate(spec) if a == "data"), None)


def _parts_dim(spec: tuple) -> Optional[int]:
    """The dim where a leaf's parts lie (``Sharding.parts``): the first one
    cut over a mesh axis other than the data axes.  A slot's spec also cuts
    its ``embed`` dim over ``data``, and that dim holds no parts."""
    for d, axis in enumerate(spec):
        flat = axis if isinstance(axis, tuple) else (axis,)
        if axis is not None and any(a not in DATA_AXES for a in flat):
            return d
    return None


def _index(dims: dict, mesh, axis) -> int:
    """This rank's index over ``axis`` (a name or a tuple, major first)."""
    idx = 0
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        idx = idx * dims[a] + mesh.get_local_rank(a)
    return idx


def shard_of(t: torch.Tensor, spec: tuple, mesh, parts: int = 1
             ) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` laid out by ``spec`` (a
    view when ``parts`` is 1).  With ``parts`` > 1 the dim that holds them
    (the first cut over a model axis) holds that many equal parts, and the
    shard is this rank's slice of each, in order: ``[x_r | z_r]`` of ``[x |
    z]``; any other cut dim is sliced whole."""
    dims = mesh_dims(mesh)
    at = _parts_dim(spec)
    for d, axis in enumerate(spec):
        if axis is not None:
            k = parts if d == at else 1
            piece = t.shape[d] // k
            n = piece // _mesh_size(dims, axis)
            lo = _index(dims, mesh, axis) * n
            cuts = [t.narrow(d, j * piece + lo, n) for j in range(k)]
            t = cuts[0] if k == 1 else torch.cat(cuts, d)
    return t


def _whole(t: torch.Tensor, spec: tuple, mesh, parts: int = 1
           ) -> torch.Tensor:
    """The inverse of ``shard_of`` on every rank: an all_gather over each
    sharded dim's axis (of each part)."""
    from repro_torch.core.distributed import all_gather
    at = _parts_dim(spec)
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        pieces = list(t.chunk(parts if d == at else 1, d))
        for a in reversed(axis if isinstance(axis, tuple) else (axis,)):
            pieces = [torch.cat(list(all_gather(x.contiguous(), mesh, a)), d)
                      for x in pieces]
        t = torch.cat(pieces, d)
    return t


@torch.no_grad()
def shard_params(model, mesh, rules: Optional[dict] = None):
    """Cut each of ``model``'s parameters to this rank's shard in place (a
    copy of the shard replaces the whole tensor), by ``model_specs``;
    records the cut as ``model.sharding``; returns ``model``."""
    from repro_torch.sharding.axes import param_parts
    specs = model_specs(model, mesh, rules)
    dims = mesh_dims(mesh)
    parts = {}
    for name, p in model.named_parameters():
        k = param_parts(name)
        d = _parts_dim(specs[name])
        if k > 1 and d is not None:
            size = _mesh_size(dims, specs[name][d])
            if p.shape[d] % (k * size):
                raise ValueError(f"{name}: {k} parts of {p.shape[d]} do not "
                                 f"split over {size} ranks")
            parts[name] = k
    for name, p in model.named_parameters():
        p.data = shard_of(p.data, specs[name], mesh,
                          parts.get(name, 1)).clone()
    model.sharding = Sharding(mesh, specs, parts)
    return model


def gather_params(named: dict, sharding: Sharding) -> dict:
    """``{name: whole tensor}`` of ``{name: local shard}`` (parameters, their
    grads or moments, by the names ``sharding.specs`` holds): an all_gather
    over each sharded dim's axis, on every rank."""
    return {name: _whole(t, sharding.specs[name], sharding.mesh,
                         sharding.parts_of(name))
            for name, t in named.items()}


# --- decode caches --------------------------------------------------------------

def cache_specs(cache, mesh, rules: Optional[dict] = None) -> dict:
    """``{port path: spec}`` of a whole decode cache (``Model.cache_shape``
    serves), by ``spec_for`` of each leaf's logical axes
    (``sharding.axes.cache_leaf_axes``)."""
    from repro_torch.sharding.axes import cache_leaf_axes, cache_leaves
    rules = {**DEFAULT_RULES, **(rules or {})}
    return {path: spec_for(cache_leaf_axes(path, t.dim()), t.shape, mesh,
                           rules)
            for path, t in cache_leaves(cache).items()}


def cache_sharding(cache, mesh, rules: Optional[dict] = None) -> Sharding:
    """How :func:`shard_cache` cuts the whole ``cache`` (or its meta shapes,
    ``Model.cache_shape`` outside a binding) over ``mesh``."""
    return Sharding(mesh, cache_specs(cache, mesh, rules))


def cut_cache(cache, sharding: Sharding, fn):
    """``sharding.axes.cache_map(cache, fn)``, each attention cache's
    ``seq`` set where ``sharding`` cuts its positions over a model dim of
    more than one rank (``layers.KVCache``)."""
    from repro_torch.sharding.axes import cache_map
    many = mesh_dims(sharding.mesh).get("model", 1) > 1

    def mark(path, c):
        axis = sharding.specs[f"{path}.k"][1]
        return c._replace(seq=many and "model" in (
            axis if isinstance(axis, tuple) else (axis,)))
    return cache_map(cache, fn, mark)


@torch.no_grad()
def shard_cache(cache, mesh, rules: Optional[dict] = None):
    """The cache's counterpart of ``shard_params``: a copy of this rank's
    shard of each leaf of the whole ``cache``, by ``cache_sharding``."""
    sharding = cache_sharding(cache, mesh, rules)
    return cut_cache(cache, sharding, lambda path, t: shard_of(
        t, sharding.specs[path], mesh).clone())


@torch.no_grad()
def gather_cache(cache, sharding: Sharding):
    """The cache's counterpart of ``gather_params``: the whole cache from
    this rank's shards cut by ``sharding`` (``cache_sharding``), on every
    rank."""
    from repro_torch.sharding.axes import cache_map
    return cache_map(
        cache, lambda path, t: _whole(t, sharding.specs[path],
                                      sharding.mesh),
        lambda path, c: c._replace(seq=False))
