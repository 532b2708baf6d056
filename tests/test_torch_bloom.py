"""The port's Bloom sketch on the CPU, Appendix B included: the properties
of ``tests/test_bloom.py`` (no false negatives ever, the filter algebra,
the false-positive rate within its bound), and parity with the JAX
package's ``repro.core.bloom`` on the same numpy keys: the Appendix-B size
models and ``false_positive_rate`` (integers exact, floats within 1e-12
relative), a counting filter's counters after adds and removes with its
membership probe, and a scalable filter's stages after growth and merge
(all exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import hypothesis_or_stubs
from repro.core import bloom as jbloom
from repro_torch.core import bloom
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

given, settings, st = hypothesis_or_stubs()

U32 = st.integers(min_value=0, max_value=2**32 - 2)


def _keys(a):
    return torch.as_tensor(np.asarray(a, np.uint32).astype(np.int64))


def _ones(n):
    return torch.ones(n, dtype=torch.bool)


def _build(keys, nb, seed, valid=None):
    ks = _keys(keys)
    return bloom.build(ks, _ones(len(ks)) if valid is None else valid, nb,
                       seed)


# -- the properties of test_bloom.py ----------------------------------------

@settings(max_examples=25, deadline=None)
@given(st.lists(U32, min_size=1, max_size=300), st.integers(0, 5))
def test_no_false_negatives(keys, seed):
    nb = bloom.num_blocks_for(len(keys), 0.01)
    f = _build(keys, nb, seed)
    assert bool(bloom.contains(f, _keys(keys)).all())


@settings(max_examples=10, deadline=None)
@given(st.lists(U32, min_size=1, max_size=100),
       st.lists(U32, min_size=1, max_size=100), st.integers(0, 3))
def test_union_covers_both(a, b, seed):
    nb = bloom.num_blocks_for(200, 0.01)
    u = bloom.union(_build(a, nb, seed), _build(b, nb, seed))
    assert bool(bloom.contains(u, _keys(a + b)).all())


@settings(max_examples=10, deadline=None)
@given(st.lists(U32, min_size=1, max_size=100),
       st.lists(U32, min_size=1, max_size=100), st.integers(0, 3))
def test_intersect_superset_of_intersection(a, b, seed):
    """AND of filters contains (at least) the true intersection (§3.1)."""
    nb = bloom.num_blocks_for(200, 0.01)
    inter = bloom.intersect(_build(a, nb, seed), _build(b, nb, seed))
    common = sorted(set(a) & set(b))
    if common:
        assert bool(bloom.contains(inter, _keys(common)).all())


def test_fpr_within_bound():
    n = 20_000
    keys = torch.arange(n)
    for target in (0.1, 0.01, 0.001):
        nb = bloom.num_blocks_for(n, target)
        f = bloom.build(keys, _ones(n), nb, seed=3)
        probe = torch.arange(10 * n, 12 * n)
        fpr = float(bloom.contains(f, probe).float().mean())
        # split-block costs a small constant vs optimal flat; allow 4x slack
        assert fpr <= max(4 * target, 5e-4), (target, fpr)
        pred = bloom.false_positive_rate(nb, n)
        assert fpr <= 3 * pred + 1e-4


def test_valid_mask_respected():
    keys = torch.arange(100)
    nb = bloom.num_blocks_for(100, 0.001)
    f = bloom.build(keys, keys < 50, nb, seed=1)
    assert bool(bloom.contains(f, keys[:50]).all())
    # invalid keys mostly absent (none were added)
    assert float(bloom.contains(f, keys[50:]).float().mean()) < 0.2


def test_eq27_sizing_monotonic():
    assert bloom.num_blocks_for(1000, 0.01) <= bloom.num_blocks_for(
        10_000, 0.01)
    assert bloom.num_blocks_for(1000, 0.01) <= bloom.num_blocks_for(
        1000, 0.001)


def test_counting_filter_remove():
    keys = torch.arange(100)
    f = bloom.counting_empty(64, seed=2, device="cpu")
    f = bloom.counting_add(f, keys, _ones(100))
    assert bool(bloom.counting_contains(f, keys).all())
    f = bloom.counting_add(f, keys[:50], _ones(50), sign=-1)
    assert bool(bloom.counting_contains(f, keys[50:]).all())
    assert float(bloom.counting_contains(f, keys[:50]).float().mean()) < 0.3


def test_appendix_b_size_ordering():
    """Fig. 15: regular < counting < invertible; scalable finite."""
    n, p = 100_000, 0.01
    flat = bloom.flat_filter_bits(n, p)
    assert flat < bloom.counting_filter_bits(n, p) \
        < bloom.invertible_filter_bits(n, p)
    assert bloom.scalable_filter_bits(n, p) > 0


def test_fill_fraction_near_half_at_design_load():
    n = 50_000
    nb = bloom.num_blocks_for(n, 0.01)
    f = bloom.build(torch.arange(n), _ones(n), nb)
    assert 0.2 < float(bloom.fill_fraction(f)) < 0.6


def test_scalable_filter_grows_and_merges():
    """Appendix B-III: an SBF spills to new stages past capacity, never
    loses a key, and merges stage-pairwise."""
    a = bloom.ScalableFilter(initial_capacity=256, fp_rate=0.01, seed=1,
                             device="cpu")
    ka = np.arange(2000, dtype=np.uint32)
    a.add(ka)
    assert len(a.stages) >= 3
    assert bool(a.contains(ka).all())
    b = bloom.ScalableFilter(initial_capacity=256, fp_rate=0.01, seed=1,
                             device="cpu")
    kb = np.arange(5000, 6000, dtype=np.uint32)
    b.add(kb)
    m = a.merge(b)
    assert bool(m.contains(ka).all()) and bool(m.contains(kb).all())
    fpr = float(m.contains(np.arange(10**5, 10**5 + 10**4, dtype=np.uint32))
                .float().mean())
    assert fpr < 0.15
    with pytest.raises(ValueError, match="seeds"):
        a.merge(bloom.ScalableFilter(seed=2, device="cpu"))


# -- against the JAX package -------------------------------------------------

SIZES = [(1, 0.5), (1000, 0.01), (100_000, 0.01), (12_345, 0.001),
         (1 << 20, 0.05)]


@pytest.mark.parametrize("n,p", SIZES)
def test_filter_bits_match_jax(n, p):
    for name in ("flat_filter_bits", "counting_filter_bits",
                 "invertible_filter_bits", "scalable_filter_bits"):
        got, want = getattr(bloom, name)(n, p), getattr(jbloom, name)(n, p)
        assert type(got) is int and got == int(want), name
    assert bloom.counting_filter_bits(n, p, counter_bits=8) \
        == jbloom.counting_filter_bits(n, p, counter_bits=8)
    assert bloom.scalable_filter_bits(n, p, initial=512, growth=4,
                                      tightening=0.5) \
        == jbloom.scalable_filter_bits(n, p, initial=512, growth=4,
                                       tightening=0.5)


@pytest.mark.parametrize("nb,n", [(1, 1), (64, 100), (4096, 20_000),
                                  (1 << 20, 1 << 24), (8, 1000)])
def test_false_positive_rate_matches_jax(nb, n):
    got, want = bloom.false_positive_rate(nb, n), \
        jbloom.false_positive_rate(nb, n)
    assert got == pytest.approx(want, rel=1e-12, abs=0.0)


def _jkeys(a):
    return jnp.asarray(np.asarray(a, np.uint32))


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_counting_filter_matches_jax(seed):
    """Counters after adds (one key set twice) and removes, and the probe
    over members and non-members, equal the JAX package's exactly."""
    rng = np.random.default_rng(seed & 0xFF)
    keys = rng.integers(0, 2**32 - 1, 3000).astype(np.uint32)
    valid = rng.random(3000) > 0.2
    probe = np.concatenate([keys, rng.integers(0, 2**32 - 1, 3000)
                            .astype(np.uint32)])
    nb = bloom.num_blocks_for(3000, 0.01)
    f = bloom.counting_empty(nb, seed=seed, device="cpu")
    jf = jbloom.counting_empty(nb, seed=seed)
    for ks, vs, sign in ((keys, valid, 1), (keys[:500], valid[:500], 1),
                         (keys[:1000], valid[:1000], -1)):
        f = bloom.counting_add(f, _keys(ks), torch.as_tensor(vs), sign=sign)
        jf = jbloom.counting_add(jf, _jkeys(ks), jnp.asarray(vs), sign=sign)
        np.testing.assert_array_equal(f.counts.numpy(), np.asarray(jf.counts))
    assert f.counts.dtype == torch.int32 and int(f.counts.min()) >= 0
    got = bloom.counting_contains(f, _keys(probe)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jbloom.counting_contains(jf, _jkeys(probe))))
    assert got[1000:3000][valid[1000:]].all()      # never a false negative


def _same_stages(f, jf):
    assert (f.caps, f.counts) == (jf.caps, jf.counts)
    assert f.errs == jf.errs
    assert (f._next_cap, f._next_err) == (jf._next_cap, jf._next_err)
    assert len(f.stages) == len(jf.stages)
    for s, js in zip(f.stages, jf.stages):
        np.testing.assert_array_equal(s.to_numpy(), np.asarray(js.words))


def test_scalable_filter_matches_jax():
    """Stages (capacities, errors, counts, words) after growth (the second
    add fills stage 1 and spills into stage 2) and after merging two
    filters of different depths, and contains over members and
    non-members, equal the JAX package's exactly."""
    rng = np.random.default_rng(4)
    adds = [rng.integers(0, 2**32 - 1, n).astype(np.uint32)
            for n in (128, 300)]
    probe = np.concatenate(adds + [rng.integers(0, 2**32 - 1, 4000)
                                   .astype(np.uint32)])
    built = []
    for parts in (adds, adds[:1]):
        f = bloom.ScalableFilter(initial_capacity=128, fp_rate=0.02, seed=3,
                                 device="cpu")
        jf = jbloom.ScalableFilter(initial_capacity=128, fp_rate=0.02, seed=3)
        for ks in parts:
            f.add(ks)
            jf.add(ks)
            _same_stages(f, jf)
        built.append((f, jf))
    (a, ja), (b, jb) = built
    assert len(a.stages) >= 3 > len(b.stages)
    for f, jf in ((a, ja), (a.merge(b), ja.merge(jb)),
                  (b.merge(a), jb.merge(ja))):
        _same_stages(f, jf)
        np.testing.assert_array_equal(f.contains(probe).numpy(),
                                      np.asarray(jf.contains(probe)))
