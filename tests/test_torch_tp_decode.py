"""Decode of a sharded model on gloo CPU ranks, with a ``kv_seq``-sharded
cache, against the JAX package's jitted ``decode_step`` and the meshless
port.

Reduced configs, in float32 compute: ``falcon-mamba-7b`` and
``recurrentgemma-2b`` (local channel states; the hybrid's local attention
has one kv head, which no model dim divides), ``whisper-small`` (its
cross-attention cache whole on every rank), ``qwen3-1.7b`` (GQA: the kv
heads shard at 2 and replicate at 4) and ``gemma2-9b`` with a window of 16
(the local ring buffer wraps; softcaps), on ``(1, 2)``, ``(1, 4)`` and
``(2, 2)`` meshes.  Each case decodes a prefix of 20 tokens meshless, cuts
that cache to each rank's shard (``shard_cache``) and decodes 8 more
tokens on the ranks:

* the gathered logits within 1e-3 (a scan on the path) or 1e-4 of the
  scale of the JAX package's logits of the same steps;
* ``init_cache`` under the binding allocates each leaf at the local shape
  ``spec_for`` gives its ``cache_axes`` (the whole over ``tp`` where it
  cuts), whisper's cross-attention keys those of the JAX package;
* after the steps each leaf keeps that local shape, ``pos`` equals the
  meshless cache's, and ``gather_cache`` gives the meshless cache (each
  leaf within the same bound of its scale);
* an attention cache is marked as holding a slice of the positions
  (``KVCache.seq``), fresh and cut alike, exactly where its ``k`` is cut.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import ARCHS
from repro_torch.sharding.axes import cache_axes, cache_leaves
from repro_torch.sharding.specs import local_shape, spec_for
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_dist import spawn
from torch_models_parity import batch, float32_compute, models, rel
from torch_train_ranks import tp_decode_rank

CASES = (("falcon-mamba-7b", {}), ("recurrentgemma-2b", {}),
         ("whisper-small", {}), ("qwen3-1.7b", {}),
         ("gemma2-9b", {"window": 16}))
MESHES = ((1, 2), (1, 4), (2, 2))
B, PREFIX, STEPS, MAX_SEQ = 4, 20, 8, 32


def tol(cfg) -> float:
    return 1e-3 if cfg.family in ("ssm", "hybrid") else 1e-4


def reference_path(path: str) -> tuple:
    """(the reference's cache path, the layer) of a port cache path."""
    keys = path.split(".")
    layer = next(int(k) for k in keys if k.isdigit())
    return ".".join(k for k in keys if not k.isdigit()), layer


@pytest.fixture(scope="module")
def reference():
    """Per case: (port config, JAX params as numpy, tokens, frames, the
    JAX package's logits of the last STEPS steps and cross-attention keys,
    the meshless port's cache after the prefix and after every step, its
    whole cache's meta shapes)."""
    out = []
    with pytest.MonkeyPatch.context() as mp, float32_compute(mp):
        for arch, kw in CASES:
            jm, p, tm = models(arch, **kw)
            cfg = ARCHS[arch].reduced(**kw)
            nb = batch(jm.cfg, B=B, T=PREFIX + STEPS)
            toks = nb["tokens"]
            frames = nb.get("frames")
            if cfg.is_encdec:
                jc = jm.init_cache(p, B, MAX_SEQ, jnp.asarray(frames))
                tc = tm.init_cache(B, MAX_SEQ, torch.from_numpy(frames))
                jcross = [np.asarray(jc.cross_k[i])
                          for i in range(cfg.n_layers)]
            else:
                jc = jm.init_cache(None, B, MAX_SEQ)
                tc = tm.init_cache(B, MAX_SEQ)
                jcross = None
            step = jax.jit(jm.decode_step)
            jd = []
            for t in range(PREFIX + STEPS):
                lj, jc = step(p, jnp.asarray(toks[:, t]), jc)
                if t >= PREFIX:
                    jd.append(np.asarray(lj))
                if t == PREFIX:
                    prefix = {k: v.clone().numpy() for k, v in
                              cache_leaves(tc).items()}
                tc = tm.decode_step(torch.from_numpy(toks[:, t]), tc)[1]
            final = {k: v.numpy() for k, v in cache_leaves(tc).items()}
            out.append((cfg, jax.tree.map(np.asarray, p), toks, frames,
                        np.stack(jd, 1), jcross, prefix, final,
                        tm.cache_shape(B, MAX_SEQ)))
    return out


def expected_local(meta, dims) -> dict:
    """{port path: local shape} of a whole meta cache over mesh ``dims``,
    by ``spec_for`` of the reference's ``cache_axes`` (stacked shapes)."""
    leaves = cache_leaves(meta)
    axes = cache_axes(meta)
    n = {}
    for path in leaves:
        ref, layer = reference_path(path)
        n[ref] = max(n.get(ref, 0), layer + 1)
    out = {}
    for path, t in leaves.items():
        ref = reference_path(path)[0]
        shape = (n[ref],) + tuple(t.shape)
        out[path] = local_shape(spec_for(axes[ref], shape, dims), shape,
                                dims)[1:]
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_decode_matches_jax(shape, reference, tmp_path):
    dp, tp = shape
    cases = [(cfg, tree, toks[:, PREFIX:], frames, MAX_SEQ, prefix)
             for cfg, tree, toks, frames, _, _, prefix, _, _ in reference]
    ranks = spawn(tp_decode_rank, dp * tp, (cases,), tmp_path,
                  mesh_shape=shape)
    dims = {"data": dp, "model": tp}
    for i, (cfg, _, _, _, jd, jcross, _, final, meta) in enumerate(reference):
        bound = tol(cfg)
        want = expected_local(meta, dims)
        cut = 0
        for r, got in enumerate(ranks):
            got = got[i]
            rows = slice(*got["rows"])
            assert rel(jd[rows], got["logits"])[0] <= bound, (cfg.name, r)
            for k, t in cache_leaves(meta).items():
                assert got["whole"][k] == tuple(t.shape), (cfg.name, k)
                assert got["fresh"][k][0] == want[k], (cfg.name, k)
                assert got["local"][k] == want[k], (cfg.name, k)
                assert got["fresh"][k][1] == str(t.dtype), (cfg.name, k)
                if np.prod(want[k]) * tp * dp == t.numel():
                    cut += 1
            for marks in got["seq"]:
                assert marks == {
                    k[:-2]: want[k][1] < cache_leaves(meta)[k].shape[1]
                    for k in want if k.endswith(".k")}, (cfg.name, marks)
            np.testing.assert_array_equal(got["cache"]["blocks.0.c_0.pos"
                                                       if not cfg.is_encdec
                                                       else "self_kv.0.pos"],
                                          PREFIX + STEPS)
            for k, w in final.items():
                scale = float(np.abs(w).max()) or 1.0
                err = float(np.abs(got["cache"][k] - w).max()) / scale
                assert err <= bound, (cfg.name, shape, k, err)
            if jcross is not None:
                for j, w in zip(got["cross"], jcross):
                    assert rel(w[rows], j)[0] <= bound, (cfg.name, r)
        # the attention caches cut their positions; the states their
        # channels
        kinds = [k for k in want if k.endswith((".k", ".h"))]
        assert kinds and all(
            want[k][1] * tp
            == cache_leaves(meta)[k].shape[1] for k in kinds), cfg.name
        assert cut, cfg.name
