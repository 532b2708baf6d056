"""Sequence parallelism (the ``seq`` rule bound) of the port on gloo CPU
ranks against the JAX package (one device, jitted).

Reduced configs of the three whose rules cut ``seq`` over ``model``, in
float32 compute, on ``(1, 2)`` and ``(2, 2)`` meshes, and a form of each
closer to full width, whose heads (and ``ff``, vocabulary, frames) do not
divide the model dim as the full config's do not at 16:

* ``qwen2-0.5b``: heads and ``ff`` cut (attention and MLP between an
  all_gather and a reduce_scatter of the sequence), the vocabulary cut (the
  lookup's reduce_scatter, the logits' all_to_all to seq chunks); and 3
  heads, ``d_ff`` 129 and 255 tokens: the chunk's queries against the
  whole sequence's keys, a pointwise MLP, a whole table;
* ``recurrentgemma-2b``: the RG-LRU's channels cut, its scan on the whole
  sequence, its local attention's one kv head replicated;
* ``whisper-small``: both stacks cut (16 frames), and 3 heads over 15
  frames: the encoder whole, as 1,500 frames over 16 are.

The gathered logits and the loss within 1e-4 (1e-3 on a scan) of the scale
of the JAX package's, every grad within the same bound of its leaf's scale
of ``jax.grad``'s (a missed grad sum shows as a factor of the model dim),
replicated leaves' grads equal on every rank; and the census of the loss
and its backward: reduce_scatters and all_gathers of the sequence in place
of the activations' all_reduces, each moving one rank's chunk of the
activation as the ring model gives it ((k - 1) x a chunk), and the logits'
all_to_all where the vocabulary is cut.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.models import ARCHS
from repro_torch.models.config import EncoderCfg
from repro_torch.sharding.specs import spec_for
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_dist import spawn
from torch_models_parity import batch, float32_compute, models, rel
from torch_train_ranks import tp_rank

CASES = (("qwen2-0.5b", {}),
         ("qwen2-0.5b", {"n_heads": 3, "n_kv_heads": 1, "d_ff": 129,
                         "vocab": 255}),
         ("recurrentgemma-2b", {}),
         ("whisper-small", {}),
         ("whisper-small", {"n_heads": 3, "n_kv_heads": 3, "vocab": 255,
                            "encoder": EncoderCfg(2, 15, 8)}))
MESHES = ((1, 2), (2, 2))
B, T = 4, 16


@pytest.fixture(scope="module")
def reference():
    """Per case: (port config, JAX params as numpy, batch, JAX logits,
    JAX loss, JAX grads by dotted path)."""
    out = []
    with pytest.MonkeyPatch.context() as mp, float32_compute(mp):
        for arch, kw in CASES:
            jm, p, _ = models(arch, **kw)
            nb = batch(jm.cfg, B=B, T=T)
            jb = {k: jnp.asarray(v) for k, v in nb.items()}
            jl, jmet = jax.jit(lambda p, b: (jm.forward(p, b)[0],
                                             jm.loss(p, b)[1]))(p, jb)
            jg = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(p, jb)
            grads = {".".join(str(k.key) for k in path): np.asarray(leaf)
                     for path, leaf in
                     jax.tree_util.tree_flatten_with_path(jg)[0]}
            out.append((ARCHS[arch].reduced(**kw),
                        jax.tree.map(np.asarray, p), nb, np.asarray(jl),
                        float(jmet["loss"]), grads))
    return out


def _census(census: list) -> dict:
    """{kind: (calls, bytes)} of a census."""
    out: dict = {}
    for c in census:
        calls, nbytes = out.get(c["kind"], (0, 0))
        out[c["kind"]] = (calls + c["calls"], nbytes + c["bytes"])
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_seq_parallel_matches_jax(shape, reference, tmp_path):
    dp, tp = shape
    ranks = spawn(tp_rank, dp * tp, ([(cfg, tree, nb) for cfg, tree, nb, *_
                                      in reference], {"seq": "model"}),
                  tmp_path, mesh_shape=shape)
    for i, (cfg, tree, nb, jl, jloss, jgrads) in enumerate(reference):
        bound = 1e-3 if cfg.family == "hybrid" else 1e-4
        rows = B // dp
        for r, got in enumerate(ranks):
            got = got[i]
            d = r // tp
            sl = slice(d * rows, (d + 1) * rows)
            assert rel(jl[sl], got["logits"])[0] <= bound, (cfg.name, r)
            assert abs(got["metrics"]["loss"] - jloss) <= bound * abs(jloss)
            for k, w in jgrads.items():
                scale = float(np.abs(w).max()) or 1.0
                err = float(np.abs(got["grads"][k] - w).max()) / scale
                assert err <= bound, (cfg.name, shape, k, err)
            for k, g in got["replicated"].items():
                np.testing.assert_array_equal(g, ranks[0][i]["replicated"][k],
                                              err_msg=f"{cfg.name} {k}")
            # the census of the loss and its backward (float32 compute)
            c = _census(got["census"])
            chunk = rows * T // tp * cfg.d_model * 4 * (tp - 1)
            ag, rs = c["all_gather"], c["reduce_scatter"]
            # as many of each, less the reduce_scatter that ends a remat
            # block, whose recompute stops at the last tensor it saved
            assert 0 < rs[0] <= ag[0], (cfg.name, c)
            assert ag[1] == ag[0] * chunk and rs[1] == rs[0] * chunk, \
                (cfg.name, c, chunk)
            vocab_cut = spec_for(("vocab",), (cfg.vocab,),
                                 {"model": tp})[0] is not None
            a2a = c.get("all_to_all", (0, 0))
            want = (2 * rows * T * cfg.vocab * 4 * (tp - 1) // tp ** 2
                    if vocab_cut else 0)
            assert a2a == ((2, want) if vocab_cut else (0, 0)), (cfg.name, c)
