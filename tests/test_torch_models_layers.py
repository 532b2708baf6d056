"""The model stack's layers, JAX package against the port on the CPU.

The same numpy inputs and parameters go through each function of
``repro.models.{layers,moe,ssm,rglru}`` and its port in
``repro_torch.models``.  In float32 (``COMPUTE_DTYPE`` patched in both
packages) results agree within 1e-5 of their scale, the scans (which combine
in another order) within 1e-4; in bf16 a single layer within 2e-2 of its
scale (one rounding step of an op now and then); integer outputs (the MoE's
expert choices and overflow counts) are equal.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ARCHS
from repro.models import layers as JL
from repro.models import moe as JMoE
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMoE
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_models_parity import no_grad  # noqa: F401  (autouse)
from torch_models_parity import float32_compute, rel


@pytest.fixture
def f32(monkeypatch):
    with float32_compute(monkeypatch):
        yield


def compute(dtype, monkeypatch):
    return float32_compute(monkeypatch) if dtype == "float32" else \
        contextlib.nullcontext()


def jit(fn):
    """``fn(p, x, cfg, ...)`` jitted, ``cfg`` and ``kind`` static: one
    compile instead of one for every op."""
    kind = ("kind",) if fn in (JL.attention_train, JL.attention_decode) \
        else ()
    return jax.jit(fn, static_argnums=(2,), static_argnames=kind)


def to_params(tree) -> TL.Params:
    """A JAX parameter dict as the port's Params (numpy in between)."""
    return TL.Params(**{k: to_params(v) if isinstance(v, dict) else
                        torch.from_numpy(np.array(v, np.float32))
                        for k, v in tree.items()})


def inputs(shape, seed=0, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(
        np.float32)


def both(x, dtype):
    """x as a JAX and a torch array of the compute dtype."""
    jd = {"float32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bf16": torch.bfloat16}[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def close(want, got, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    err = rel(np.asarray(jnp.asarray(want, jnp.float32)), got)[0]
    assert err <= tol, err


# --- norms, rope, softcap, positions ----------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_norms_match(dtype):
    d = 64
    x = inputs((2, 8, d), 1, 3.0)
    scale = inputs((d,), 2, 0.1)
    bias = inputs((d,), 3, 0.1)
    xj, xt = both(x, dtype)
    tol = 1e-6 if dtype == "float32" else 1e-2
    close(JL.rmsnorm({"scale": scale}, xj, 1e-5),
          TL.rmsnorm(to_params({"scale": scale}), xt, 1e-5), tol)
    p = {"scale": scale, "bias": bias}
    close(JL.layernorm(p, xj, 1e-5), TL.layernorm(to_params(p), xt, 1e-5),
          tol)


@pytest.mark.parametrize("theta", [1e4, 1e6, 0.0])
def test_rope_matches(theta):
    x = inputs((2, 12, 4, 16), 4)
    pos = np.random.default_rng(5).integers(0, 5000, (2, 12)).astype(
        np.int32)
    close(JL.rope(jnp.asarray(x), jnp.asarray(pos), theta),
          TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta), 2e-5)


def test_softcap_and_sinusoidal_embedding_match():
    x = inputs((3, 50), 6, 40.0)
    for cap in (None, 30.0, 50.0):
        close(JL.softcap(jnp.asarray(x), cap),
              TL.softcap(torch.from_numpy(x), cap), 1e-6)
    # angles reach 1,500 rad, where one float32 step of a frequency moves
    # the angle by 2e-4
    pos = np.arange(0, 1500, 7, dtype=np.int32)
    for d in (64, 768):
        close(JL.sinusoidal_embedding(jnp.asarray(pos), d),
              TL.sinusoidal_embedding(torch.from_numpy(pos), d), 1e-3)


# --- attention ----------------------------------------------------------------

ATTN = [("qwen3-1.7b", "causal"), ("qwen3-1.7b", "local"),
        ("qwen3-1.7b", "full"), ("gemma2-9b", "local"),
        ("qwen2-0.5b", "causal"), ("granite-20b", "causal")]


def _attention(arch, seed=0, **overrides):
    cfg = ARCHS[arch].reduced(**overrides)
    p = jax.tree.map(np.asarray, JL.init_attention(jax.random.key(seed), cfg))
    if cfg.qkv_bias:      # the reference initialises biases to 0
        for i, b in enumerate(("bq", "bk", "bv")):
            p[b] = inputs(p[b].shape, 10 + i, 0.5)
    return cfg, p


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("arch,kind", ATTN)
def test_attention_train_matches(arch, kind, dtype, monkeypatch):
    cfg, p = _attention(arch, window=12)
    x = inputs((2, 40, cfg.d_model), 7)
    with compute(dtype, monkeypatch):
        xj, xt = both(x, dtype)
        close(jit(JL.attention_train)(p, xj, cfg, kind=kind),
              TL.attention_train(to_params(p), xt, cfg, kind=kind),
              1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("arch,kind", ATTN)
def test_chunked_attention_matches_dense(arch, kind, f32):
    """The port's chunked online softmax (attn_chunk 16 over 64 tokens)
    against the reference's chunked and dense attention."""
    cfg, p = _attention(arch, window=12)
    cfgc = dataclasses.replace(cfg, attn_chunk=16)
    x = inputs((2, 64, cfg.d_model), 8)
    got = TL.attention_train(to_params(p), torch.from_numpy(x), cfgc,
                             kind=kind)
    for c in (cfg, cfgc):
        close(JL.attention_train(p, jnp.asarray(x), c, kind=kind), got, 1e-5)


def test_cross_attention_and_cross_kv_match(f32):
    cfg, p = _attention("whisper-small")
    x, enc = inputs((2, 5, cfg.d_model), 9), inputs((2, 16, cfg.d_model), 10)
    jkv = JL.cross_kv(p, jnp.asarray(enc), cfg)
    tkv = TL.cross_kv(to_params(p), torch.from_numpy(enc), cfg)
    for a, b in zip(jkv, tkv):
        close(a, b, 1e-6)
    close(JL.attention_train(p, jnp.asarray(x), cfg, kind="cross", kv=jkv),
          TL.attention_train(to_params(p), torch.from_numpy(x), cfg,
                             kind="cross", kv=tkv), 1e-5)


@pytest.mark.parametrize("kind", ["causal", "local"])
def test_attention_decode_matches_past_the_window(kind, f32):
    """20 one-token steps; the local ring buffer of 8 wraps twice."""
    cfg, p = _attention("gemma2-9b", window=8)
    xs = inputs((2, 20, cfg.d_model), 11)
    jc = JL.init_kv_cache(cfg, 2, 20, kind)
    tc = TL.init_kv_cache(cfg, 2, 20, kind, device="cpu")
    tp = to_params(p)
    assert tuple(tc.k.shape) == jc.k.shape and tc.k.dtype == torch.float32
    for t in range(20):
        yj, jc = jit(JL.attention_decode)(p, jnp.asarray(xs[:, t:t + 1]), cfg, jc,
                                     kind=kind)
        yt, tc = TL.attention_decode(tp, torch.from_numpy(xs[:, t:t + 1]),
                                     cfg, tc, kind=kind)
        close(yj, yt, 1e-5)
    close(jc.k, tc.k, 1e-6)
    np.testing.assert_array_equal(np.asarray(jc.pos), tc.pos.numpy())


# --- feed-forward -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-9b",
                                  "whisper-small"])
def test_mlp_kinds_match(arch, dtype, monkeypatch):
    """swiglu, geglu and gelu (with its biases)."""
    cfg = ARCHS[arch].reduced()
    p = jax.tree.map(np.asarray, JL.init_mlp(jax.random.key(1), cfg))
    for b in ("bu", "bd"):
        if b in p:
            p[b] = inputs(p[b].shape, 12, 0.3)
    x = inputs((2, 10, cfg.d_model), 13)
    with compute(dtype, monkeypatch):
        xj, xt = both(x, dtype)
        close(JL.mlp(p, xj, cfg), TL.mlp(to_params(p), xt, cfg),
              1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("arch,tokens,capacity_factor", [
    ("qwen2-moe-a2.7b", (2, 9), 1.25),       # decode-sized: lossless
    ("moonshot-v1-16b-a3b", (4, 600), 1.25),  # N*K > 4096: capacity
    ("moonshot-v1-16b-a3b", (4, 600), 0.5),   # tokens dropped
])
def test_moe_ffn_matches(arch, tokens, capacity_factor, f32):
    """Outputs, aux loss, the router's expert choices and the overflow
    count; float32 only, where bf16 rounding could flip a top-k choice."""
    cfg = ARCHS[arch].reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    p = jax.tree.map(np.asarray, JMoE.init_moe(jax.random.key(2), cfg))
    x = inputs(tokens + (cfg.d_model,), 14)
    yj, aj = jit(JMoE.moe_ffn)(p, jnp.asarray(x), cfg)
    tp = to_params(p)
    yt, at = TMoE.moe_ffn(tp, torch.from_numpy(x), cfg)
    close(yj, yt, 1e-5)
    close(aj["moe_aux_loss"], at["moe_aux_loss"], 1e-5)
    assert int(aj["moe_overflow"]) == int(at["moe_overflow"])
    if capacity_factor < 1:
        assert int(at["moe_overflow"]) > 0
    xf = x.reshape(-1, cfg.d_model)
    probs = jax.nn.softmax(jnp.asarray(xf) @ p["router"], axis=-1)
    _, top_e = jax.lax.top_k(probs, cfg.moe.top_k)
    _, _, t_top = TMoE.route(tp, torch.from_numpy(xf), cfg)
    np.testing.assert_array_equal(np.asarray(top_e), t_top.numpy())


# --- scans --------------------------------------------------------------------

def test_associative_scan_equals_the_recurrence():
    rng = np.random.default_rng(15)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 3)))
    b = torch.from_numpy(rng.normal(0, 1, (2, 37, 3)))
    pa, h = TS.associative_scan(a, b, dim=1)
    want_h, want_a = torch.zeros(2, 3, dtype=a.dtype), torch.ones(2, 3,
                                                                  dtype=a.dtype)
    for t in range(37):
        want_h = a[:, t] * want_h + b[:, t]
        want_a = want_a * a[:, t]
        torch.testing.assert_close(h[:, t], want_h, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(pa[:, t], want_a, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("T", [40, 512])
def test_mamba_train_and_decode_match(T, f32):
    """T = 512 is two chunks of SCAN_CHUNK (the state carried across);
    T = 40 one.  Then 12 decode steps."""
    cfg = ARCHS["falcon-mamba-7b"].reduced()
    p = jax.tree.map(np.asarray, JS.init_mamba(jax.random.key(3), cfg))
    x = inputs((2, T, cfg.d_model), 16)
    tp = to_params(p)
    close(jit(JS.mamba_train)(p, jnp.asarray(x), cfg),
          TS.mamba_train(tp, torch.from_numpy(x), cfg), 1e-4)
    jc, tc = JS.init_mamba_cache(cfg, 2), TS.init_mamba_cache(cfg, 2, "cpu")
    for t in range(12):
        yj, jc = jit(JS.mamba_decode)(p, jnp.asarray(x[:, t:t + 1]), cfg, jc)
        yt, tc = TS.mamba_decode(tp, torch.from_numpy(x[:, t:t + 1]), cfg, tc)
        close(yj, yt, 1e-5)
    close(jc.h, tc.h, 1e-5)


def test_rglru_train_and_decode_match(f32):
    cfg = ARCHS["recurrentgemma-2b"].reduced()
    p = jax.tree.map(np.asarray, JR.init_rglru(jax.random.key(4), cfg))
    x = inputs((2, 100, cfg.d_model), 17)
    tp = to_params(p)
    close(jit(JR.rglru_train)(p, jnp.asarray(x), cfg),
          TR.rglru_train(tp, torch.from_numpy(x), cfg), 1e-4)
    jc, tc = JR.init_rglru_cache(cfg, 2), TR.init_rglru_cache(cfg, 2, "cpu")
    for t in range(12):
        yj, jc = jit(JR.rglru_decode)(p, jnp.asarray(x[:, t:t + 1]), cfg, jc)
        yt, tc = TR.rglru_decode(tp, torch.from_numpy(x[:, t:t + 1]), cfg, tc)
        close(yj, yt, 1e-5)
    close(jc.h, tc.h, 1e-5)
