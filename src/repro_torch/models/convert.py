"""Weights carried across from the JAX package.

The reference keeps a model's parameters in one pytree of float32 arrays
whose scanned stacks (``trunk.blocks``, whisper's ``encdec.enc_blocks`` and
``encdec.dec_blocks``) carry the layer on a leading axis.  The port keeps
the same names with each stack unstacked into an ``nn.ModuleList``
(``trunk.blocks.3.mix_0.wq``); a layer's expert weights stay one
[E, d, ffe] tensor, as the batched expert product takes them.  Tied
embeddings have no ``head`` in either package, so they stay tied.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.models.model import Model

STACKS = ("trunk.blocks", "encdec.enc_blocks", "encdec.dec_blocks")
_UNSTACKED = re.compile(r"^(%s)\.(\d+)\.(.+)$" % "|".join(
    re.escape(s) for s in STACKS))


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def params_from_jax(cfg, tree: dict, device="cuda") -> Model:
    """A :class:`Model` on ``device`` (the card by default) holding the JAX
    package's parameters ``tree`` (nested dicts of numpy arrays, as
    ``jax.tree.map(np.asarray, repro.models.Model(cfg).init(key))`` gives).
    Every leaf must land on a parameter and every parameter be filled."""
    model = Model(cfg, device=device)
    state = {}
    for path, leaf in _flatten(tree):
        arr = torch.from_numpy(np.ascontiguousarray(leaf, np.float32))
        stack = next((s for s in STACKS if path.startswith(s + ".")), None)
        if stack is None:
            state[path] = arr
            continue
        rest = path[len(stack) + 1:]
        for i in range(arr.shape[0]):
            state[f"{stack}.{i}.{rest}"] = arr[i]
    model.load_state_dict(state, strict=True)
    return model


def params_to_jax(model: Model) -> dict:
    """The inverse: ``model``'s parameters as the JAX package's pytree of
    float32 numpy arrays, the stacks stacked again."""
    stacked: dict = {}
    tree: dict = {}
    for name, t in model.state_dict().items():
        arr = t.detach().float().cpu().numpy()
        m = _UNSTACKED.match(name)
        if m:
            stack, i, rest = m.group(1), int(m.group(2)), m.group(3)
            stacked.setdefault(f"{stack}.{rest}", {})[i] = arr
        else:
            _put(tree, name, arr)
    for path, layers in stacked.items():
        _put(tree, path, np.stack([layers[i] for i in range(len(layers))]))
    return tree


def _put(tree: dict, path: str, leaf) -> None:
    *heads, last = path.split(".")
    for h in heads:
        tree = tree.setdefault(h, {})
    tree[last] = leaf
