"""The JAX side of ``tests/test_torch_moe_ep.py``, run as a script in a
subprocess of its own (8 host devices, as the reference's distributed tests
run): the JAX package's ``moe_ffn_ep`` under ``logical_rules`` and its
meshless ``moe_ffn``, both jitted, in float32 compute, on each case of
``CASES``; writes one ``.npz`` a case (inputs, weights, outputs) and the
list of cases (``cases.json``) into the directory named by its argument.
The test process reads that list and never imports this module, which
sets ``XLA_FLAGS``.

Usage: python tests/torch_moe_ep_jax.py OUT_DIR
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import ARCHS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.sharding.specs import logical_rules  # noqa: E402

# (name, (data, model), experts, capacity factor): block-EP at model 2 and
# 4, ffe-TP (6 experts over 4), DP x EP; with drops (1.25) and without (8)
CASES = [(f"{name}-cf{cf}", mesh, experts, cf)
         for name, mesh, experts in (("ep12", (1, 2), 8), ("ep14", (1, 4), 8),
                                     ("ffe14", (1, 4), 6), ("dpep22", (2, 2), 8))
         for cf in (1.25, 8.0)]
X_SHAPE = (4, 1024)       # [B, T]: N * K = 8192 > 4096, 4096 a data rank
# every token shares one offset, which the router maps to one offset an
# expert: the loads are skewed, and the popular experts overflow at 1.25


def config(experts: int, cf: float):
    cfg = ARCHS["qwen2-moe-a2.7b"].reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=experts, capacity_factor=cf))


def case(out_dir: str, name: str, shape, experts: int, cf: float) -> None:
    cfg = config(experts, cf)
    p = JMoE.init_moe(jax.random.key(0), cfg)
    x = jax.random.normal(jax.random.key(1), X_SHAPE + (cfg.d_model,),
                          jnp.float32) \
        + jax.random.normal(jax.random.key(2), (cfg.d_model,), jnp.float32)
    mesh = jax.make_mesh(shape, ("data", "model"))
    with logical_rules(mesh):
        y_ep, a_ep = jax.jit(lambda p, x: JMoE.moe_ffn_ep(p, x, cfg))(p, x)
    y, a = jax.jit(lambda p, x: JMoE.moe_ffn(p, x, cfg))(p, x)
    flat = {"w." + ".".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]}
    np.savez(os.path.join(out_dir, f"{name}.npz"), x=np.asarray(x),
             y_ep=np.asarray(y_ep), aux_ep=np.asarray(a_ep["moe_aux_loss"]),
             ovf_ep=np.asarray(a_ep["moe_overflow"]), y=np.asarray(y),
             aux=np.asarray(a["moe_aux_loss"]),
             ovf=np.asarray(a["moe_overflow"]), **flat)


def main(out_dir: str) -> None:
    JL.COMPUTE_DTYPE = jnp.float32
    JMoE.COMPUTE_DTYPE = jnp.float32
    for name, shape, experts, cf in CASES:
        case(out_dir, name, shape, experts, cf)
    with open(os.path.join(out_dir, "cases.json"), "w") as f:
        json.dump(CASES, f)
    print("MOE-EP-JAX-OK")


if __name__ == "__main__":
    main(sys.argv[1])
