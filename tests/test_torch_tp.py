"""Tensor and expert parallelism of the port's model stack on gloo CPU ranks
against the JAX package (one device, jitted) and the meshless port.

Reduced configs, in float32 compute, at model 2 and 4 (a (1, tp) mesh):
``qwen3-1.7b`` (GQA: kv heads shard at 2, replicate at 4 while the heads
shard), ``qwen2-0.5b`` with 14 heads, 2 kv heads and a vocabulary of 254
(everything shards at 2; at 4 the heads, kv heads and vocabulary
replicate, the MLP shards), ``qwen2-moe-a2.7b`` with 6 experts (block-EP at
2, ffe-TP at 4, a shared expert) and ``phi-3-vision-4.2b`` (image tokens):

* the gathered logits and the loss within 1e-4 of the scale of the JAX
  package's ``jax.jit`` forward, and the grads gathered to the reference's
  layout within 1e-4 of each leaf's scale of ``jax.grad``'s;
* every shard has the shape ``spec_for`` gives (``model_specs``), every
  replicated leaf's grad is equal on every model rank, and a train step's
  clipping norm is the whole model's (within 1e-5 of ``jax.grad``'s);
* the launcher trains at ``--dp 2 --tp 2``; its checkpoint loads into the
  JAX package's train state and resumes at ``--dp 1 --tp 1``: the next
  loss and the last within the DP tolerances (rtol 5e-3, atol 5e-4) of an
  uninterrupted run at (1, 1) (bf16, as the launcher computes); an ssm
  arch trains at ``--tp 2`` too, and its checkpoint (Mamba's ``in_proj``
  put back whole from its halves) loads into the JAX package's train
  state and holds the params of a run at ``--tp 1`` within those
  tolerances.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ARCHS as JARCHS
from repro.models import Model as JModel
from repro.runtime import checkpoint as JCK
from repro.runtime.train import train_state_init as jstate_init
from repro_torch.models import ARCHS
from repro_torch.runtime import checkpoint as TCK
from repro_torch.sharding.specs import local_shape, model_specs
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_dist import spawn
from torch_models_parity import batch, float32_compute, models, rel
from torch_train_ranks import tp_rank

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
CASES = (("qwen3-1.7b", {}),
         ("qwen2-0.5b", dict(n_heads=14, n_kv_heads=2, head_dim=8,
                             vocab=254)),
         ("qwen2-moe-a2.7b", {}),
         ("phi-3-vision-4.2b", {}))


def _moe6(arch, kw):
    """The moe case holds 6 experts: block-EP at 2, ffe-TP at 4."""
    if arch != "qwen2-moe-a2.7b":
        return kw
    import dataclasses
    moe = ARCHS[arch].reduced().moe
    return {**kw, "moe": dataclasses.replace(moe, num_experts=6)}


@pytest.fixture(scope="module")
def reference():
    """Per case: (port config, JAX params as numpy, batch, JAX logits,
    JAX loss, JAX grads by dotted path, the meshless port's logits, the
    meshless port's model)."""
    out = []
    with pytest.MonkeyPatch.context() as mp, float32_compute(mp):
        for arch, kw in CASES:
            kw = _moe6(arch, kw)
            jm, p, tm = models(arch, **kw)
            nb = batch(jm.cfg)
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


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_forward_and_grads_match_jax(tp, reference, tmp_path):
    ref = reference
    ranks = spawn(tp_rank, tp, ([(cfg, tree, nb) for cfg, tree, nb, *_
                                 in ref],), tmp_path, mesh_shape=(1, tp))
    for i, (cfg, _, _, jl, jloss, jgrads, tl, tm) in enumerate(ref):
        specs = model_specs(tm, {"data": 1, "model": tp})
        whole = dict(tm.named_parameters())
        norm = float(np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                                 for g in jgrads.values())))
        for r, got in enumerate(ranks):
            got = got[i]
            assert rel(jl, got["logits"])[0] <= TOL, (cfg.name, r)
            assert rel(tl, got["logits"])[0] <= TOL, (cfg.name, r)
            assert abs(got["metrics"]["loss"] - jloss) <= TOL * abs(jloss)
            assert set(got["grads"]) == set(jgrads)
            for k, w in jgrads.items():
                scale = float(np.abs(w).max()) or 1.0
                err = float(np.abs(got["grads"][k] - w).max()) / scale
                assert err <= TOL, (cfg.name, k, err)
            for k, shape in got["shapes"].items():
                assert shape == local_shape(specs[k], whole[k].shape,
                                            {"model": tp}), (cfg.name, k)
            for k, g in got["replicated"].items():
                np.testing.assert_array_equal(g, ranks[0][i]["replicated"][k],
                                              err_msg=f"{cfg.name} {k}")
            assert abs(got["grad_norm"] - norm) <= 1e-5 * norm, \
                (cfg.name, got["grad_norm"], norm)
        sharded = {k for k, s in specs.items() if any(s)}
        assert sharded, cfg.name
        assert "embed" in sharded or cfg.vocab % tp, cfg.name


def _start(ckpt_dir, *extra) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "2"}
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--steps", "6", "--ckpt-every", "2", "--batch", "4",
         "--seq", "32", "--ckpt-dir", str(ckpt_dir), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=env)


def _done(proc: subprocess.Popen) -> subprocess.CompletedProcess:
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _launch(ckpt_dir, *extra) -> subprocess.CompletedProcess:
    return _done(_start(ckpt_dir, *extra))


def _last_loss(stdout: str) -> float:
    line = [ln for ln in stdout.splitlines() if ln.startswith("[train] step")]
    return float(line[-1].split("loss=")[1].split()[0])


def _next_loss(ckpt_dir) -> float:
    """The loss of step 4's batch under the launcher's step-4 checkpoint,
    on one process (the launcher's config, weights and batches)."""
    from repro_torch.launch.train import arch_config, make_batch_fn
    from repro_torch.models import Model
    from repro_torch.runtime.train import (load_train_state,
                                           train_state_init,
                                           train_state_tree)
    cfg = arch_config("qwen2-moe-a2.7b", True)
    model = Model(cfg, device="cpu")
    like = train_state_tree(train_state_init(model))
    tree, _ = TCK.restore_checkpoint(str(ckpt_dir), 4, like, device="cpu")
    load_train_state(tree, model)
    with torch.no_grad():
        loss, _ = model.loss(make_batch_fn(cfg, 4, 32, device="cpu")(4))
    return float(loss)


def test_launcher_tp_checkpoint_resumes_anywhere(tmp_path):
    arch = ("--arch", "qwen2-moe-a2.7b")
    straight = _start(tmp_path / "one", *arch)
    ssm = ("--arch", "falcon-mamba-7b", "--steps", "2")
    ssm_runs = {tp: _start(tmp_path / f"ssm{tp}", *ssm, "--tp", str(tp))
                for tp in (1, 2)}
    out = _launch(tmp_path / "tp", *arch, "--dp", "2", "--tp", "2",
                  "--steps", "4")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "dp 2 x tp 2" in out.stdout
    assert TCK.latest_step(str(tmp_path / "tp")) == 4
    # the gathered checkpoint loads into the JAX package's train state
    from repro_torch.launch.train import arch_config
    jcfg = JARCHS["qwen2-moe-a2.7b"]
    jcfg = jcfg.reduced(vocab=512, d_model=128, d_ff=256,
                        n_layers=len(jcfg.mixer_pattern) * 2)
    assert jcfg.d_model == arch_config("qwen2-moe-a2.7b", True).d_model
    like = jstate_init(JModel(jcfg), jax.random.key(0))
    restored, _ = JCK.restore_checkpoint(str(tmp_path / "tp"), 4, like)
    assert jax.tree.structure(restored) == jax.tree.structure(like)
    assert int(restored.opt.step) == 4
    # resumed at (1, 1): its last loss, and the next loss from the (2, 2)
    # checkpoint, against the uninterrupted (1, 1) run's
    out = _launch(tmp_path / "tp", *arch)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[train] resumed from step 4" in out.stdout
    one = _done(straight)
    assert one.returncode == 0, one.stderr[-3000:]
    np.testing.assert_allclose(_last_loss(out.stdout),
                               _last_loss(one.stdout), rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(_next_loss(tmp_path / "tp"),
                               _next_loss(tmp_path / "one"), rtol=5e-3,
                               atol=5e-4)
    # the ssm arch trains at --tp 2; the JAX package restores its
    # checkpoint, whose params are those of the run at --tp 1
    for tp, proc in ssm_runs.items():
        out = _done(proc)
        assert out.returncode == 0, out.stderr[-3000:]
        assert f"dp 1 x tp {tp}" in out.stdout
    jcfg = JARCHS["falcon-mamba-7b"]
    jcfg = jcfg.reduced(vocab=512, d_model=128, d_ff=256, n_layers=2)
    like = jstate_init(JModel(jcfg), jax.random.key(0))
    got = {tp: JCK.restore_checkpoint(str(tmp_path / f"ssm{tp}"), 2, like)[0]
           for tp in (1, 2)}
    assert jax.tree.structure(got[2]) == jax.tree.structure(like)
    assert int(got[2].opt.step) == 2
    for path, w in jax.tree_util.tree_flatten_with_path(got[1].params)[0]:
        np.testing.assert_allclose(
            np.asarray(_at(got[2].params, path)), np.asarray(w), rtol=5e-3,
            atol=5e-4, err_msg=jax.tree_util.keystr(path))


def _at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b"])
def test_tp_dp_training_matches_one_process(arch, tmp_path):
    """3 steps on a (2, 2) mesh of the global [8, 32] batch against one
    process, in float32 compute: losses and params within rtol 5e-3, atol
    5e-4 (the DP tolerances), the overflow equal."""
    from torch_train_ranks import train_span
    cfg = ARCHS[arch].reduced(vocab=128)
    ranks = spawn(train_span, 4, (cfg, 0, 3, 3, 8, 32, False, None, True),
                  tmp_path, mesh_shape=(2, 2))
    one = train_span(None, "cpu", cfg, 0, 3, 3, 8, 32, float32=True)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=5e-3,
                                   atol=5e-4)
        assert r["overflow"] == one["overflow"]
        for k, w in one["params"].items():
            np.testing.assert_allclose(r["params"][k], w, rtol=5e-3,
                                       atol=5e-4, err_msg=k)
