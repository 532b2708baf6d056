"""The JAX package's parameter layout at the production meshes, in a
process of its own: ``python tests/torch_dryrun_jax.py <out.json>
<arch>...``.

It sets ``XLA_FLAGS`` for 512 host devices before JAX is imported, so a
test process must run it as a subprocess, never import it.  For each arch,
without compiling anything: ``jax.eval_shape`` of its parameters, their
logical axes, ``param_specs`` over the ``(16, 16)`` ``("data", "model")``
mesh and each leaf's shard shape (by dotted path), the same of the ZeRO-1
slots (``param_specs(..., rules=ZERO1_RULES)``, as the dry run's
``--zero1`` lays out AdamW's ``m`` and ``v``) over it and over the ``(2,
16, 16)`` ``("pod", "data", "model")`` mesh, and ``count_params``.
"""

import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.launch import roofline as RL  # noqa: E402
from repro.launch.dryrun import ZERO1_RULES  # noqa: E402
from repro.models import Model  # noqa: E402
from repro.sharding.axes import param_axes  # noqa: E402
from repro.sharding.specs import param_specs  # noqa: E402

devices = np.array(jax.devices())
mesh = Mesh(devices[:256].reshape(16, 16), ("data", "model"))
multi = Mesh(devices.reshape(2, 16, 16), ("pod", "data", "model"))


def shards(shapes, axes, mesh, rules=None) -> dict:
    """Each leaf's shard shape, by dotted path."""
    specs = param_specs(axes, shapes, mesh, rules)
    return {".".join(str(k.key) for k in path): list(sh.shard_shape(
        leaf.shape)) for (path, leaf), sh in zip(
            jax.tree_util.tree_flatten_with_path(shapes)[0],
            jax.tree.leaves(specs))}


out = {}
for arch in sys.argv[2:]:
    cfg = ARCHS[arch]
    shapes = jax.eval_shape(Model(cfg).init, jax.random.key(0))
    axes = param_axes(shapes, cfg)
    out[arch] = {"shards": shards(shapes, axes, mesh),
                 "slots": shards(shapes, axes, mesh, ZERO1_RULES),
                 "shards_multipod": shards(shapes, axes, multi),
                 "slots_multipod": shards(shapes, axes, multi, ZERO1_RULES),
                 "counts": list(RL.count_params(shapes, cfg))}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
