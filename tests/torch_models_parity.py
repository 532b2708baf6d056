"""Shared harness of the model-stack parity tests: one arch at ``reduced()``
through the JAX package and through the port with the same weights
(``params_from_jax``) and the same numpy inputs.

Tolerances (each relative to the scale of the JAX package's logits, their
largest magnitude):

* **float32** (``COMPUTE_DTYPE`` patched to float32 in both packages'
  ``layers``, ``moe``, ``ssm`` and ``rglru`` modules, and the KV cache's
  dtype with it): the largest difference within 1e-4 for the attention
  archs and 1e-3 for Mamba and RG-LRU, whose scans combine in another
  order;
* **bf16** (the default): the mean difference within 2e-2 and the largest
  within 0.08, the bound of the reference's own bf16 decode test
  (``tests/test_models.py``).  A single bf16 op of the two packages differs
  by one rounding step now and then (their matmuls accumulate in another
  order); through a few layers that moves the largest logit by up to
  4.6e-2 of the scale, as little as bf16 itself moves either package's
  logits from its float32 ones (4-9e-2), so the largest difference cannot
  be held to 2e-2.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ARCHS as JARCHS
from repro.models import Model as JModel
from repro.models import layers as JL
from repro.models import moe as JMoE
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro.models.model import CLIP_DIM
from repro_torch.models import ARCHS as TARCHS
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMoE
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from repro_torch.models.convert import params_from_jax

TIGHT = {"ssm": 1e-3, "hybrid": 1e-3}   # by family; 1e-4 otherwise
LOOSE_MEAN, LOOSE_MAX = 2e-2, 0.08


@contextlib.contextmanager
def float32_compute(monkeypatch):
    """Both packages compute in float32, caches included (the KV cache's
    dtype is a default bound when ``init_kv_cache`` is defined)."""
    with monkeypatch.context() as m:
        for mod in (JL, JMoE, JS, JR):
            m.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
        for mod in (TL, TMoE, TS, TR):
            m.setattr(mod, "COMPUTE_DTYPE", torch.float32)
        m.setattr(JL.init_kv_cache, "__defaults__", (jnp.float32,))
        m.setattr(TL.init_kv_cache, "__defaults__", (torch.float32, "cuda"))
        yield


@pytest.fixture(autouse=True)
def no_grad():
    """Forward and decode parity records no autograd graph: the parameters
    are trainable, and a graph would keep every activation and refuse
    ``.numpy()``.  Autouse in a module that imports it."""
    with torch.no_grad():
        yield


def tight_tol(cfg) -> float:
    return TIGHT.get(cfg.family, 1e-4)


def batch(cfg, B=2, T=16, seed=1) -> dict:
    """numpy tokens, targets and the stub frontends' inputs."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T + 1))
    b = {"tokens": toks[:, :-1].astype(np.int32),
         "targets": toks[:, 1:].astype(np.int32)}
    if cfg.num_img_tokens:
        b["img_embeds"] = rng.normal(
            0, 1, (B, cfg.num_img_tokens, CLIP_DIM)).astype(np.float32)
    if cfg.is_encdec:
        e = cfg.encoder
        b["frames"] = rng.normal(0, 1, (B, e.n_frames, e.d_input)
                                 ).astype(np.float32)
    return b


def models(arch: str, seed: int = 0, **overrides):
    """(jax model, its params, port model on the CPU with the same
    weights) for ``arch`` at ``reduced(**overrides)``."""
    jcfg = JARCHS[arch].reduced(**overrides)
    jm = JModel(jcfg)
    p = jax.jit(jm.init)(jax.random.key(seed))
    tm = params_from_jax(TARCHS[arch].reduced(**overrides),
                         jax.tree.map(np.asarray, p), device="cpu")
    return jm, p, tm


def rel(want, got) -> tuple:
    """(largest, mean) |got - want| over the largest |want|."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    d = np.abs(got - want)
    scale = np.abs(want).max()
    return d.max() / scale, d.mean() / scale


def run_both(jm, p, tm, nb: dict, decode_steps: int):
    """Forward logits, loss metrics and ``decode_steps`` decode logits from
    an empty cache, from each package: ((jax...), (port...))."""
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    jl, jmet = jax.jit(lambda p, b: (jm.forward(p, b)[0],
                                     jm.loss(p, b)[1]))(p, jb)
    tl, _ = tm.forward(tb)
    _, tmet = tm.loss(tb)
    B = nb["tokens"].shape[0]
    S = decode_steps
    if jm.cfg.is_encdec:
        jc = jm.init_cache(p, B, S, jb["frames"])
        tc = tm.init_cache(B, S, tb["frames"])
    else:
        jc = jm.init_cache(None, B, S)
        tc = tm.init_cache(B, S)
    step = jax.jit(jm.decode_step)
    jd, td = [], []
    for t in range(decode_steps):
        lj, jc = step(p, jb["tokens"][:, t], jc)
        lt, tc = tm.decode_step(tb["tokens"][:, t], tc)
        jd.append(np.asarray(lj))
        td.append(lt.numpy())
    jmet = {k: float(v) for k, v in jmet.items()}
    tmet = {k: float(v) for k, v in tmet.items()}
    return ((np.asarray(jl), jmet, np.stack(jd, 1)),
            (tl.numpy(), tmet, np.stack(td, 1)))


def check_arch(arch: str, dtype: str, monkeypatch, T: int = 16) -> dict:
    """Forward logits, loss and T decode steps of ``arch`` at ``reduced()``
    in both packages, at ``dtype``'s tolerance (module docstring); returns
    the measured errors."""
    ctx = float32_compute(monkeypatch) if dtype == "float32" else \
        contextlib.nullcontext()
    with ctx:
        jm, p, tm = models(arch)
        cfg = jm.cfg
        (jl, jmet, jd), (tl, tmet, td) = run_both(jm, p, tm, batch(cfg, T=T),
                                                  decode_steps=T)
    errs = {"forward": rel(jl, tl), "decode": rel(jd, td),
            "loss": abs(tmet["loss"] - jmet["loss"]) / abs(jmet["loss"])}
    for what in ("forward", "decode"):
        worst, mean = errs[what]
        if dtype == "float32":
            assert worst <= tight_tol(cfg), (what, errs)
        else:
            assert worst <= LOOSE_MAX and mean <= LOOSE_MEAN, (what, errs)
    assert errs["loss"] <= (tight_tol(cfg) if dtype == "float32"
                            else LOOSE_MEAN), errs
    assert set(tmet) == set(jmet)
    if "moe_overflow" in jmet:
        assert tmet["moe_overflow"] == jmet["moe_overflow"]
        errs["aux"] = abs(tmet["moe_aux_loss"] - jmet["moe_aux_loss"])
        assert errs["aux"] <= 1e-5 * abs(jmet["moe_aux_loss"]), errs
    return errs


def check_grads(arch: str, monkeypatch, T: int = 16) -> dict:
    """The loss's grads of ``arch`` at ``reduced()`` in both packages from
    the same weights and batch, in float32 compute: every leaf (in the
    reference's layout) within ``tight_tol`` of its own largest absolute
    grad in the JAX package.  Returns each leaf's error over that scale."""
    from repro_torch.models.convert import flatten, stack_tree
    with float32_compute(monkeypatch):
        jm, p, tm = models(arch)
        nb = batch(jm.cfg, T=T)
        jb = {k: jnp.asarray(v) for k, v in nb.items()}
        jg = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(p, jb)
        with torch.enable_grad():
            loss, _ = tm.loss({k: torch.from_numpy(v) for k, v in nb.items()})
            loss.backward()
    tg = stack_tree({k: q.grad for k, q in tm.named_parameters()})
    want = {".".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = dict(flatten(tg))
    assert set(got) == set(want)
    tol = tight_tol(jm.cfg)
    errs = {}
    for k, w in want.items():
        scale = float(np.abs(w).max())
        d = float(np.abs(got[k].numpy().astype(np.float64) - w).max())
        errs[k] = d / scale if scale else d
        assert errs[k] <= tol, (k, errs[k], scale)
    return errs
