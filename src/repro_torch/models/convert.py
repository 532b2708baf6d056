"""Weights carried across from the JAX package, and the reference's layout.

The reference keeps a model's parameters in one pytree of float32 arrays
whose scanned stacks (``trunk.blocks``, whisper's ``encdec.enc_blocks`` and
``encdec.dec_blocks``) carry the layer on a leading axis.  The port keeps
the same names with each stack unstacked into an ``nn.ModuleList``
(``trunk.blocks.3.mix_0.wq``); a layer's expert weights stay one
[E, d, ffe] tensor, as the batched expert product takes them.  Tied
embeddings have no ``head`` in either package, so they stay tied.

``stack_tree`` / ``unstack_tree`` map any ``{port name: tensor}`` dict
(parameters, AdamW moments, error-feedback buffers) to the reference's
nested, stacked layout and back; train checkpoints are written in it.
"""

from __future__ import annotations

import re
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:  # the model imports the sharding rules, which import this
    from repro_torch.models.model import Model

STACKS = ("trunk.blocks", "encdec.enc_blocks", "encdec.dec_blocks")
_UNSTACKED = re.compile(r"^(%s)\.(\d+)\.(.+)$" % "|".join(
    re.escape(s) for s in STACKS))


def flatten(tree: dict, prefix: str = ""):
    """(dotted path, leaf) of a nested dict, in its key order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def is_stacked(name: str) -> bool:
    """Whether the port's parameter ``name`` is one layer of a stack."""
    return _UNSTACKED.match(name) is not None


def reference_groups(names) -> dict:
    """{reference path: the port names it holds}: a stacked leaf holds one
    name a layer, in layer order, any other leaf its own name."""
    groups: dict = {}
    for name in names:
        m = _UNSTACKED.match(name)
        path = f"{m.group(1)}.{m.group(3)}" if m else name
        groups.setdefault(path, []).append(name)
    return {path: sorted(group, key=_layer) for path, group in groups.items()}


def _layer(name: str) -> int:
    m = _UNSTACKED.match(name)
    return int(m.group(2)) if m else 0


def stack_tree(named: dict) -> dict:
    """``named`` ({port name: tensor}) as the reference's nested dict, each
    stack stacked on a leading layer axis; the leaves are float32 copies on
    the CPU, as a checkpoint writes them."""
    tree: dict = {}
    for path, group in reference_groups(named).items():
        leaves = [named[n].detach().to("cpu", torch.float32, copy=True)
                  for n in group]
        leaf = torch.stack(leaves) if is_stacked(group[0]) else leaves[0]
        _put(tree, path, leaf)
    return tree


def unstack_tree(tree: dict) -> dict:
    """The inverse of ``stack_tree``: {port name: tensor}, each stacked
    leaf cut into its layers (views of the stacked tensor)."""
    named = {}
    for path, leaf in flatten(tree):
        stack = next((s for s in STACKS if path.startswith(s + ".")), None)
        if stack is None:
            named[path] = leaf
            continue
        rest = path[len(stack) + 1:]
        for i in range(leaf.shape[0]):
            named[f"{stack}.{i}.{rest}"] = leaf[i]
    return named


def params_from_jax(cfg, tree: dict, device="cuda", mesh=None) -> Model:
    """A :class:`Model` on ``device`` (the card by default) holding the JAX
    package's parameters ``tree`` (nested dicts of numpy arrays, as
    ``jax.tree.map(np.asarray, repro.models.Model(cfg).init(key))`` gives).
    Every leaf must land on a parameter and every parameter be filled.
    With ``mesh`` (a ``DeviceMesh`` of this rank) the model holds this
    rank's shards (``sharding.specs.shard_params``)."""
    from repro_torch.models.model import Model
    model = Model(cfg, device=device)
    state = {name: torch.from_numpy(np.array(leaf, np.float32))
             for name, leaf in unstack_tree(tree).items()}
    model.load_state_dict(state, strict=True)
    if mesh is not None:
        from repro_torch.sharding.specs import shard_params
        shard_params(model, mesh)
    return model


def params_to_jax(model: Model) -> dict:
    """The inverse: ``model``'s parameters as the JAX package's pytree of
    float32 numpy arrays, the stacks stacked again."""
    tree = stack_tree(dict(model.state_dict()))
    return _map(tree, lambda t: t.numpy())


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _put(tree: dict, path: str, leaf) -> None:
    *heads, last = path.split(".")
    for h in heads:
        tree = tree.setdefault(h, {})
    tree[last] = leaf
