"""Tensor parallelism of the Mamba and RG-LRU mixers and of whisper on gloo
CPU ranks against the JAX package (one device, jitted) and the meshless
port.

Reduced configs, in float32 compute: ``falcon-mamba-7b`` (``d_inner`` 128
over the model dim, ``in_proj`` cut as ``[x_r | z_r]``),
``recurrentgemma-2b`` (``lru`` 64 in blocks of 16: whole blocks a rank at
2 and 4; its local attention's one kv head replicates), the same with
``lru`` 80 (40 and 20 channels a rank straddle the blocks: the gates'
all_gather) and ``whisper-small`` (4 heads: both stacks and the
cross-attention shard at 2 and 4), on ``(1, 2)``, ``(1, 4)`` and ``(2, 2)``
meshes:

* the gathered logits and the loss within 1e-3 (a scan on the path) or
  1e-4 (whisper) of the scale of the JAX package's ``jax.jit`` forward and
  of the meshless port's, and the grads gathered to the reference's
  layout within the same bound of each leaf's scale of ``jax.grad``'s (on
  ``(2, 2)`` each data rank takes half the batch; the grads and loss are
  averaged over the data dim);
* every shard has the shape ``spec_for`` gives (``model_specs``), each
  rank's ``in_proj`` is ``[x_r | z_r]`` of the whole, every replicated
  leaf's grad is equal on every rank, and a train step's clipping norm is
  the whole model's.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro_torch.models import ARCHS
from repro_torch.models.config import RGLRUCfg
from repro_torch.sharding.specs import local_shape, model_specs
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_dist import spawn
from torch_models_parity import batch, float32_compute, models, rel
from torch_train_ranks import tp_rank

CASES = (("falcon-mamba-7b", {}),
         ("recurrentgemma-2b", {}),
         ("recurrentgemma-2b", {"rglru": RGLRUCfg(lru_width=80,
                                                  block_width=16)}),
         ("whisper-small", {}))
MESHES = ((1, 2), (1, 4), (2, 2))


def tol(cfg) -> float:
    return 1e-3 if cfg.family in ("ssm", "hybrid") else 1e-4


@pytest.fixture(scope="module")
def reference():
    """Per case: (port config, JAX params as numpy, batch, JAX logits,
    JAX loss, JAX grads by dotted path, the meshless port's logits, the
    meshless port's model)."""
    out = []
    with pytest.MonkeyPatch.context() as mp, float32_compute(mp):
        for arch, kw in CASES:
            jm, p, tm = models(arch, **kw)
            nb = batch(jm.cfg, B=4)
            jb = {k: jnp.asarray(v) for k, v in nb.items()}
            jl, jmet = jax.jit(lambda p, b: (jm.forward(p, b)[0],
                                             jm.loss(p, b)[1]))(p, jb)
            jg = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(p, jb)
            grads = {".".join(str(k.key) for k in path): np.asarray(leaf)
                     for path, leaf in
                     jax.tree_util.tree_flatten_with_path(jg)[0]}
            with torch.no_grad():
                tl = tm.forward({k: torch.from_numpy(v)
                                 for k, v in nb.items()})[0].numpy()
            out.append((ARCHS[arch].reduced(**kw),
                        jax.tree.map(np.asarray, p), nb, np.asarray(jl),
                        float(jmet["loss"]), grads, tl, tm))
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_scan_and_whisper_tp_match_jax(shape, reference, tmp_path):
    dp, tp = shape
    ranks = spawn(tp_rank, dp * tp, ([(cfg, tree, nb) for cfg, tree, nb, *_
                                      in reference],), tmp_path,
                  mesh_shape=shape)
    for i, (cfg, tree, nb, jl, jloss, jgrads, tl, tm) in enumerate(reference):
        bound = tol(cfg)
        specs = model_specs(tm, {"data": dp, "model": tp})
        whole = dict(tm.named_parameters())
        norm = float(np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                                 for g in jgrads.values())))
        B = len(nb["tokens"])
        for r, got in enumerate(ranks):
            got = got[i]
            d, m = divmod(r, tp)
            rows = slice(d * B // dp, (d + 1) * B // dp)
            assert rel(jl[rows], got["logits"])[0] <= bound, (cfg.name, r)
            assert rel(tl[rows], got["logits"])[0] <= bound, (cfg.name, r)
            assert abs(got["metrics"]["loss"] - jloss) <= bound * abs(jloss)
            assert set(got["grads"]) == set(jgrads)
            for k, w in jgrads.items():
                scale = float(np.abs(w).max()) or 1.0
                err = float(np.abs(got["grads"][k] - w).max()) / scale
                assert err <= bound, (cfg.name, shape, k, err)
            for k, s in got["shapes"].items():
                assert s == local_shape(specs[k], whole[k].shape,
                                        {"model": tp}), (cfg.name, k)
            for k, shard in got["in_proj"].items():
                w = whole[k].detach().numpy()
                n = w.shape[1] // 2 // tp
                want = np.concatenate([w[:, m * n:(m + 1) * n],
                                       w[:, (tp + m) * n:(tp + m + 1) * n]],
                                      1)
                np.testing.assert_array_equal(shard, want, err_msg=k)
            for k, g in got["replicated"].items():
                np.testing.assert_array_equal(g, ranks[0][i]["replicated"][k],
                                              err_msg=f"{cfg.name} {k}")
            assert abs(got["grad_norm"] - norm) <= bound * norm, \
                (cfg.name, got["grad_norm"], norm)
        sharded = {k for k, s in specs.items() if any(s)}
        mixers = {"ssm": "in_proj", "hybrid": "in_x", "audio": "dec_blocks"}
        assert any(mixers[cfg.family] in k for k in sharded), cfg.name
        if cfg.ssm:
            assert got["in_proj"], cfg.name
