"""The port's training path beside the JAX package's: the token source, the
int8 codes, AdamW and its schedule, train steps from the same weights,
microbatching and block remat (the batch mixture:
``test_torch_train_sharding.py``).

Tolerances: ``lm_batch`` tokens, int8 codes and the mixture's keys and
counts are equal as integers; ``cosine_schedule`` is equal at steps 0,
warmup and total; one AdamW update is within 1e-6 relative (the global
norm and the fused moment updates round in another order); five train
steps in float32 compute within rtol 1e-3 of the JAX package's losses;
two microbatches within 1e-5 of one batch's grads (a sum in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as JP
from repro.optim import adamw as JA
from repro.optim import compress as JC
from repro.runtime.train import make_train_step as jmake_step
from repro_torch.data import pipeline as TP
from repro_torch.optim import adamw as TA
from repro_torch.optim import compress as TC
from repro_torch.runtime.train import make_train_step, train_state_init
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_models_parity import float32_compute, models


@pytest.mark.parametrize("structured", [False, True])
@pytest.mark.parametrize("step,shard,vocab,batch,seq", [
    (0, 0, 97, 4, 256), (5, 2, 151_936, 2, 300), (123_456, 7, 512, 3, 64),
    (70_000, 1, 32_768, 2, 1024)])
def test_lm_batch_equals_the_references(structured, step, shard, vocab,
                                        batch, seq):
    want = JP.lm_batch(step, shard, batch=batch, seq=seq, vocab=vocab,
                       seed=3, structured=structured)
    got = TP.lm_batch(step, shard, batch=batch, seq=seq, vocab=vocab,
                      seed=3, structured=structured, device="cpu")
    for k in ("tokens", "targets"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_codes_bit_equal(seed):
    """Codes, scale and the round trip bit for bit, ties at .5 included
    (both round half to even)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 10.0 ** -seed, (64, 33)).astype(np.float32)
    x[0, :4] = [0.5, 1.5, -2.5, 3.5]
    x[0, 4] = 127.0 * max(np.abs(x).max() / 127.0, 1.0)
    jc, js = JC.compress_int8(jnp.asarray(x))
    tc, ts = TC.compress_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.dtype == torch.int8
    assert ts.item() == float(js)
    np.testing.assert_array_equal(
        TC.decompress_int8(tc, ts).numpy(),
        np.asarray(JC.decompress_int8(jc, js)))


def test_cosine_schedule_equal_at_its_corners():
    warmup, total = 10, 100
    jlr = JA.cosine_schedule(3e-4, warmup, total)
    tlr = TA.cosine_schedule(3e-4, warmup, total)
    for s in (0, warmup, total):
        want = np.float32(jlr(jnp.asarray(s, jnp.int32)))
        got = tlr(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.item() == want, s
    for s in (3, 40, 77, 250):
        want = float(jlr(jnp.asarray(s, jnp.int32)))
        assert abs(tlr(torch.tensor(s, dtype=torch.int32)).item() - want) \
            <= 1e-6 * want


def _tree(rng, shapes):
    return {k: rng.normal(0, 1, s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("gscale", [1e-3, 10.0])
def test_adamw_update_matches(gscale):
    """Two updates from the same params, grads and state (the second with
    nonzero moments), clipped (``gscale`` 10) and not."""
    rng = np.random.default_rng(0)
    shapes = {"a": (17, 9), "b": (5,), "c": (3, 4, 2)}
    p = _tree(rng, shapes)
    gs = [{k: v * gscale for k, v in _tree(rng, shapes).items()}
          for _ in range(2)]
    jlr = JA.cosine_schedule(1e-2, 1, 10)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    js = JA.adamw_init(jp)
    ts = TA.adamw_init(tp)
    for g in gs:
        jp, js, jm = JA.adamw_update(jp, {k: jnp.asarray(v)
                                          for k, v in g.items()}, js,
                                     lr_fn=jlr)
        tp, ts, tm = TA.adamw_update(tp, {k: torch.from_numpy(v.copy())
                                          for k, v in g.items()}, ts,
                                     lr_fn=TA.cosine_schedule(1e-2, 1, 10))
        assert int(ts.step) == int(js.step) and ts.step.dtype == torch.int32
        assert tm["lr"].item() == float(jm["lr"])
        assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
        for tree_t, tree_j in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            for k in shapes:
                want = np.asarray(tree_j[k])
                np.testing.assert_allclose(tree_t[k].numpy(), want,
                                           rtol=1e-6, atol=1e-6 * np.abs(
                                               want).max())


def _torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-moe-a2.7b",
                                  "recurrentgemma-2b"])
def test_train_steps_match_jax(arch, monkeypatch):
    """Five steps from the same weights on the same structured batches, in
    float32 compute: every loss, nll and grad norm within rtol 1e-3 of the
    JAX package's, the lr within 1e-6."""
    with float32_compute(monkeypatch):
        jm, p, tm = models(arch)
        cfg = jm.cfg
        jstep = jax.jit(jmake_step(jm, total_steps=10, warmup=2))
        from repro.runtime.train import TrainState
        jst = TrainState(p, JA.adamw_init(p), None)
        tstep = make_train_step(tm, total_steps=10, warmup=2)
        tst = train_state_init(tm)
        for i in range(5):
            b = JP.lm_batch(i, 0, batch=4, seq=32, vocab=cfg.vocab,
                            structured=True)
            jst, jmet = jstep(jst, b)
            tst, tmet = tstep(tst, _torch_batch(b))
            assert set(tmet) == set(jmet)
            for k in ("loss", "nll", "grad_norm"):
                want = float(jmet[k])
                assert abs(float(tmet[k]) - want) <= 1e-3 * abs(want), \
                    (i, k, float(tmet[k]), want)
            # cos in float32 may round a step apart between the libraries
            assert abs(float(tmet["lr"]) - float(jmet["lr"])) <= \
                1e-6 * float(jmet["lr"])


def _grads(model, batch):
    for p in model.parameters():
        p.grad = None
    loss, _ = model.loss(batch)
    loss.backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def test_microbatches_give_the_grads_of_one_batch(monkeypatch):
    """``microbatches=2`` accumulates the two halves' grads and averages:
    in float32 compute the grads one batch gives within 1e-5 of each leaf's
    scale, and the loss with them (in bf16 a half-batch's products round
    elsewhere)."""
    from repro_torch.models import ARCHS, Model
    cfg = ARCHS["qwen2-0.5b"].reduced(vocab=128)
    b = TP.lm_batch(0, 0, batch=4, seq=32, vocab=cfg.vocab,
                    structured=True, device="cpu")
    seen = {}

    def spy(params, grads, state, **kw):
        seen["grads"] = {k: g.clone() for k, g in grads.items()}
        return TA.adamw_update(params, grads, state, **kw)
    monkeypatch.setattr("repro_torch.runtime.train.adamw_update", spy)
    with float32_compute(monkeypatch):
        for mb in (1, 2):
            model = Model(cfg, device="cpu")
            step = make_train_step(model, total_steps=10, warmup=2,
                                   microbatches=mb)
            _, met = step(train_state_init(model), b)
            seen[mb] = (seen.pop("grads"), float(met["loss"]))
    (g1, l1), (g2, l2) = seen[1], seen[2]
    assert abs(l1 - l2) <= 1e-5 * abs(l1)
    for k in g1:
        scale = float(g1[k].abs().max()) or 1.0
        assert float((g1[k] - g2[k]).abs().max()) <= 1e-5 * scale, k


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-small"])
def test_block_remat_gives_the_grads_without_it(arch, monkeypatch):
    """Block remat recomputes a block's activations in the backward: the
    same grads as a model that keeps them, bit for bit on the CPU."""
    import dataclasses

    from repro_torch.models import ARCHS, Model
    from repro_torch.models import layers as L
    cfg = ARCHS[arch].reduced()
    assert cfg.remat == "block"
    model = Model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 17)))
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.is_encdec:
        e = cfg.encoder
        b["frames"] = torch.from_numpy(rng.normal(
            0, 1, (2, e.n_frames, e.d_input)).astype(np.float32))
    calls = []
    orig = L.checkpoint

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(L, "checkpoint", counted)
    with_remat = _grads(model, b)
    blocks = (cfg.encoder.n_layers + cfg.n_layers if cfg.is_encdec
              else cfg.n_layers // len(cfg.mixer_pattern))
    assert len(calls) == blocks
    model.cfg = dataclasses.replace(cfg, remat="none")
    without = _grads(model, b)
    for k in with_remat:
        assert torch.equal(with_remat[k], without[k]), k
