"""Logical-axis sharding rules: the port of the JAX package's
``sharding/specs.py`` table and its divisibility-aware spec construction.

``spec_for`` maps a tensor's logical axis names to mesh axis names over a
mesh given as ``{axis name: size}`` (a ``DeviceMesh``'s
``dict(zip(mesh.mesh_dim_names, mesh.shape))``), and returns the tuple the
reference's ``PartitionSpec`` holds: a mesh axis, a tuple of them, or None
(replicated) per dim.  Applying the specs as ``DTensor`` placements, and
the layout hints inside the model, wait for the tensor-parallel slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

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


def _mesh_size(mesh: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh.get(a, 1)
        return n
    return mesh.get(axis, 1)


def spec_for(names: Sequence, shape: Sequence[int], mesh: dict,
             rules: Optional[dict] = None) -> tuple:
    """The partition of a tensor from its logical names, dropping
    indivisible shardings (``rules`` default to ``DEFAULT_RULES``).

    An entry may be ``(name, quantum)``: the dim holds ``quantum`` semantic
    units (attention heads, experts) and only shards when whole units land
    per shard.  A mesh axis appears once per spec: its first use wins and
    later ones replicate."""
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
