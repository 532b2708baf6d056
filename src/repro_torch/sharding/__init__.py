"""Logical-axis sharding rules and the logical axes of parameters and
caches (the JAX package's ``sharding``); their application to ``DTensor``
layouts comes with the tensor-parallel slice."""

from repro_torch.sharding.axes import cache_axes, param_axes
from repro_torch.sharding.specs import DEFAULT_RULES, is_axes_leaf, spec_for

__all__ = ["DEFAULT_RULES", "is_axes_leaf", "spec_for", "cache_axes",
           "param_axes"]
