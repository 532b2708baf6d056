"""The port's model stack beside the JAX package's: weights carried across
and back, cache shapes, the local ring buffer past its window, the VLM's
image prefix, whisper's cross-attention over encoder states, the chunked
attention in a whole forward, and decode against forward in the port.

Float32 tolerances as in ``tests/torch_models_parity.py``; the decode
against forward bound is the reference's own (0.08 of the logits' scale,
``tests/test_models.py``)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import ARCHS as JARCHS
from repro.models import Model as JModel
from repro_torch.models import ARCHS, Model
from repro_torch.models.convert import params_from_jax, params_to_jax
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_models_parity import no_grad  # noqa: F401  (autouse)
from torch_models_parity import (batch, float32_compute, models, rel,
                                 run_both)

ALL = list(ARCHS)


def test_registry_equals_the_references():
    assert list(ARCHS) == list(JARCHS)
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JARCHS[name])
        assert dataclasses.asdict(cfg.reduced()) == \
            dataclasses.asdict(JARCHS[name].reduced())
        assert (cfg.hd, cfg.is_encdec, cfg.sub_quadratic) == \
            (JARCHS[name].hd, JARCHS[name].is_encdec,
             JARCHS[name].sub_quadratic)


@pytest.mark.parametrize("arch", ALL)
def test_weights_carried_across_and_back(arch):
    """Every leaf of the reference's pytree lands on a parameter (strict),
    and the port gives the same pytree back bit for bit; a model built
    from a seed has the reference's parameter shapes."""
    cfg = JARCHS[arch].reduced()
    tree = jax.tree.map(np.asarray,
                        jax.jit(JModel(cfg).init)(jax.random.key(3)))
    model = params_from_jax(ARCHS[arch].reduced(), tree, device="cpu")
    back = params_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    seeded = params_to_jax(Model(ARCHS[arch].reduced(), device="cpu"))
    assert jax.tree.map(np.shape, seeded) == jax.tree.map(np.shape, tree)
    assert ("head" in tree) == (not cfg.tie_embeddings)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-9b",
                                  "falcon-mamba-7b", "recurrentgemma-2b",
                                  "whisper-small", "phi-3-vision-4.2b"])
def test_cache_shape_matches_the_references(arch):
    """The port's caches (one a layer) hold the shapes and dtypes the
    reference stacks over its layers."""
    cfg = ARCHS[arch].reduced()
    jshape = JModel(JARCHS[arch].reduced()).cache_shape(2, 24)
    tshape = Model(cfg, device="cpu").cache_shape(2, 24)
    if cfg.is_encdec:
        assert jshape.self_kv.k.shape == (cfg.n_layers,) + tuple(
            tshape.self_kv[0].k.shape)
        assert jshape.cross_k.shape == (cfg.n_layers,) + tuple(
            tshape.cross_k[0].shape)
        assert all(t.is_meta for t in tshape.cross_k)
        return
    for key, one in tshape["blocks"][0].items():
        for j, t in zip(jshape["blocks"][key], one):
            assert j.shape == (len(tshape["blocks"]),) + tuple(t.shape)
            assert str(j.dtype) == str(t.dtype).replace("torch.", "")
            assert t.is_meta


def test_local_ring_buffer_past_its_window(monkeypatch):
    """gemma2 with a window of 8 decodes 20 tokens (the ring wraps twice):
    step for step equal to the reference in float32, and its last step
    within the reference's bound of the teacher-forced forward."""
    with float32_compute(monkeypatch):
        jm, p, tm = models("gemma2-9b", window=8)
        (jl, _, jd), (tl, _, td) = run_both(jm, p, tm,
                                            batch(jm.cfg, B=1, T=20), 20)
    assert rel(jd, td)[0] <= 1e-4
    assert rel(jl, tl)[0] <= 1e-4
    assert rel(tl[:, -1], td[:, -1])[0] < 0.08


def test_vlm_image_prefix_changes_logits_as_the_references(monkeypatch):
    with float32_compute(monkeypatch):
        jm, p, tm = models("phi-3-vision-4.2b")
        b1 = batch(jm.cfg, seed=1)
        b2 = {**b1, "img_embeds": b1["img_embeds"] + 1.0}
        got = [tm.forward({k: torch.from_numpy(v) for k, v in b.items()})[0]
               for b in (b1, b2)]
        want = [np.asarray(jm.forward(p, b)[0]) for b in (b1, b2)]
    assert float((got[0] - got[1]).abs().max()) > 1e-3
    for w, g in zip(want, got):
        assert rel(w, g.numpy())[0] <= 1e-4


def test_whisper_encoder_states_feed_decoder_as_the_references(monkeypatch):
    """New frames change the logits of forward and of decode (through the
    cross-KV precomputed once), in the port as in the reference."""
    with float32_compute(monkeypatch):
        jm, p, tm = models("whisper-small")
        b1 = batch(jm.cfg, seed=1, T=6)
        b2 = {**b1, "frames": b1["frames"] + 1.0}
        outs = [run_both(jm, p, tm, b, 6) for b in (b1, b2)]
    for (jl, _, jd), (tl, _, td) in outs:
        assert rel(jl, tl)[0] <= 1e-4 and rel(jd, td)[0] <= 1e-4
    assert np.abs(outs[0][1][0] - outs[1][1][0]).max() > 1e-3
    assert np.abs(outs[0][1][2] - outs[1][1][2]).max() > 1e-3


def test_chunked_attention_in_a_whole_forward(monkeypatch):
    """qwen3 with attn_chunk 16 over 64 tokens takes the chunked online
    softmax in every layer: equal to the reference's forward and to the
    port's dense one."""
    with float32_compute(monkeypatch):
        jm, p, tm = models("qwen3-1.7b")
        chunked = dataclasses.replace(tm.cfg, attn_chunk=16)
        b = batch(jm.cfg, T=64)
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        dense = tm.forward(tb)[0].numpy()
        tm.cfg = chunked
        got = tm.forward(tb)[0].numpy()
        want = np.asarray(jm.forward(p, b)[0])
    assert rel(want, got)[0] <= 1e-4
    assert rel(dense, got)[0] <= 1e-4


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "falcon-mamba-7b",
                                  "recurrentgemma-2b"])
def test_decode_matches_forward_in_the_port(arch):
    """At the default bf16: step-by-step decode reproduces the
    teacher-forced last-position logits within the reference's bound."""
    cfg = ARCHS[arch].reduced()
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 24)))
    logits, _ = model.forward({"tokens": toks})
    cache = model.init_cache(2, 24)
    for t in range(24):
        step, cache = model.decode_step(toks[:, t], cache)
    assert rel(logits[:, -1].numpy(), step.numpy())[0] < 0.08


def test_unscanned_tail_block_matches_the_references(monkeypatch):
    """recurrentgemma at 8 layers is 2 blocks of (rglru, rglru, local) and a
    tail of (rglru, rglru), as its 26 = 8 x 3 + 2: the tail's weights carried
    across, forward and decode equal to the reference's in float32."""
    with float32_compute(monkeypatch):
        jm, p, tm = models("recurrentgemma-2b", n_layers=8)
        assert len(tm.trunk["blocks"]) == 2 and "tail" in tm.trunk
        assert sorted(p["trunk"]["tail"]) == ["ff_0", "ff_1", "ffpre_0",
                                              "ffpre_1", "mix_0", "mix_1",
                                              "pre_0", "pre_1"]
        (jl, _, jd), (tl, _, td) = run_both(jm, p, tm, batch(jm.cfg, T=12),
                                            12)
    assert rel(jl, tl)[0] <= 1e-3 and rel(jd, td)[0] <= 1e-3
