"""Logical-axis sharding rules, the logical axes of parameters and caches
(the JAX package's ``sharding``), and their application to local shards on
a ``torch.distributed`` mesh (``specs.shard_params``, ``shard_cache``,
``logical_rules``)."""

from repro_torch.sharding.axes import cache_axes, param_axes
from repro_torch.sharding.specs import (DEFAULT_RULES, current_binding,
                                        gather_cache, gather_params,
                                        is_axes_leaf, logical_rules,
                                        param_specs, shard_cache, shard_hint,
                                        shard_params, spec_for)

__all__ = ["DEFAULT_RULES", "is_axes_leaf", "spec_for", "cache_axes",
           "param_axes", "logical_rules", "current_binding", "shard_hint",
           "param_specs", "shard_params", "gather_params", "shard_cache",
           "gather_cache"]
