"""The JAX package's parameter layout at the production mesh, in a process
of its own: ``python tests/torch_dryrun_jax.py <out.json> <arch>...``.

It sets ``XLA_FLAGS`` for 256 host devices before JAX is imported, so a
test process must run it as a subprocess, never import it.  For each arch,
without compiling anything: ``jax.eval_shape`` of its parameters, their
logical axes, ``param_specs`` over the ``(16, 16)`` ``("data", "model")``
mesh and each leaf's shard shape (by dotted path), and ``count_params``.
"""

import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.launch import roofline as RL  # noqa: E402
from repro.models import Model  # noqa: E402
from repro.sharding.axes import param_axes  # noqa: E402
from repro.sharding.specs import param_specs  # noqa: E402

mesh = Mesh(np.array(jax.devices()).reshape(16, 16), ("data", "model"))
out = {}
for arch in sys.argv[2:]:
    cfg = ARCHS[arch]
    shapes = jax.eval_shape(Model(cfg).init, jax.random.key(0))
    specs = param_specs(param_axes(shapes, cfg), shapes, mesh)
    leaves = {}
    for (path, leaf), sh in zip(
            jax.tree_util.tree_flatten_with_path(shapes)[0],
            jax.tree.leaves(specs)):
        leaves[".".join(str(k.key) for k in path)] = list(
            sh.shard_shape(leaf.shape))
    out[arch] = {"shards": leaves,
                 "counts": list(RL.count_params(shapes, cfg))}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
