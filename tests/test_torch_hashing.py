"""PyTorch port vs the JAX package: hashing, relations, Bloom filters and the
synthetic data, bit for bit on the CPU.

The same numpy inputs (made from a seed) go through ``repro`` and
``repro_torch``; every integer output must be equal."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bloom as jbloom
from repro.core import hashing as jh
import repro.core.relation  # noqa: F401  (repro.core re-exports a function so named)
from repro.data import synthetic as jsyn
from repro_torch.core import bloom as tbloom
from repro_torch.core import hashing as th
from repro_torch.core import relation as trel
from repro_torch.data import synthetic as tsyn
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

jrel = sys.modules["repro.core.relation"]

EDGE_KEYS = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint32)


def _keys(n=1 << 16, seed=0):
    """n uint32 keys from a seed, the edge values (0, 2^32-1, ...) first."""
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 2**32, n - EDGE_KEYS.size, dtype=np.uint32)
    return np.concatenate([EDGE_KEYS, rand])


def _t(a):
    return torch.as_tensor(np.asarray(a, np.uint32).astype(np.int64))


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_fmix32_bit_exact():
    k = _keys()
    np.testing.assert_array_equal(_np(jh.fmix32(jnp.asarray(k))),
                                  th.fmix32(_t(k)).numpy())
    for x in EDGE_KEYS:
        assert int(jh.fmix32(int(x))) == th.fmix32(int(x))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**32 - 1])
def test_hash2_bit_exact_int_and_tensor_seed(seed):
    k = _keys(seed=seed & 0xFFFF)
    want = _np(jh.hash2(jnp.asarray(k), seed))
    np.testing.assert_array_equal(want, th.hash2(_t(k), seed).numpy())
    np.testing.assert_array_equal(
        want, th.hash2(_t(k), torch.tensor([seed])).numpy())


def test_counter_hash_and_bounded_bit_exact():
    k = _keys(1 << 12)[:, None]
    t = np.arange(16, dtype=np.uint32)[None, :]
    for lane in (0, 1, 2):
        want = jh.counter_hash(np.uint32(2**32 - 3), jnp.asarray(k),
                               jnp.asarray(t), lane)
        got = th.counter_hash(2**32 - 3, _t(k), _t(t), lane)
        np.testing.assert_array_equal(_np(want), got.numpy())
        bound = np.arange(1, k.shape[0] + 1, dtype=np.int32)[:, None]
        np.testing.assert_array_equal(
            np.asarray(jh.bounded(want, jnp.asarray(bound))),
            th.bounded(got, torch.as_tensor(bound)).numpy())


@pytest.mark.parametrize("nb", [1, 64, 1 << 14])
def test_block_index_and_lane_masks_bit_exact(nb):
    k = _keys()
    np.testing.assert_array_equal(
        np.asarray(jbloom.block_index(jnp.asarray(k), nb, 11)),
        tbloom.block_index(_t(k), nb, 11).numpy())
    np.testing.assert_array_equal(
        _np(jbloom.lane_masks(jnp.asarray(k), 11)),
        tbloom.lane_masks(_t(k), 11).numpy())


@pytest.mark.parametrize("n,fp", [(100, 0.1), (4096, 0.01), (5000, 0.001)])
def test_bloom_build_contains_words_bit_exact(n, fp):
    rng = np.random.default_rng(n)
    k = rng.integers(0, 2**32, n, dtype=np.uint32)
    valid = rng.random(n) > 0.2
    nb = jbloom.num_blocks_for(n, fp)
    assert nb == tbloom.num_blocks_for(n, fp)
    jf = jbloom.build(jnp.asarray(k), jnp.asarray(valid), nb, seed=5)
    tf = tbloom.build(_t(k), torch.as_tensor(valid), nb, seed=5)
    np.testing.assert_array_equal(np.asarray(jf.words), tf.to_numpy())
    probe = np.concatenate([k, rng.integers(0, 2**32, n, dtype=np.uint32)])
    np.testing.assert_array_equal(
        np.asarray(jbloom.contains(jf, jnp.asarray(probe))),
        tbloom.contains(tf, _t(probe)).numpy())
    np.testing.assert_allclose(float(jbloom.fill_fraction(jf)),
                               float(tbloom.fill_fraction(tf)), rtol=1e-6)


def test_filter_words_cross_from_numpy_and_merge():
    rng = np.random.default_rng(3)
    nb = 256
    ws = [jbloom.build(jnp.asarray(rng.integers(0, 2**32, 2000,
                                                dtype=np.uint32)),
                       jnp.ones(2000, bool), nb, seed=9) for _ in range(3)]
    tf = [tbloom.BloomFilter.from_numpy(np.asarray(w.words), 9, device="cpu")
          for w in ws]
    np.testing.assert_array_equal(np.asarray(jbloom.intersect_all(ws).words),
                                  tbloom.intersect_all(tf).to_numpy())
    np.testing.assert_array_equal(np.asarray(jbloom.union(ws[0], ws[1]).words),
                                  tbloom.union(tf[0], tf[1]).to_numpy())
    with pytest.raises(ValueError, match="seed"):
        tbloom.intersect_all([tf[0], tf[1]._replace(seed=8)])
    with pytest.raises(ValueError, match="num_blocks"):
        tbloom.intersect_all([tf[0], tbloom.empty(nb * 2, 9, device="cpu")])


def test_relation_sort_fingerprint_and_from_numpy():
    rng = np.random.default_rng(4)
    n = 3000
    k = rng.choice(np.array([0, 5, 2**31 + 1, 2**32 - 2], np.uint32), n)
    v = rng.normal(size=n).astype(np.float32)
    m = rng.random(n) > 0.3
    jr = jrel.relation(k, v, m)
    tr = trel.from_numpy(k, v, m, device="cpu")
    assert trel.fingerprint(tr) == jrel.fingerprint(jr)
    js, ts = jrel.sort_by_key(jr), trel.sort_by_key(tr)
    np.testing.assert_array_equal(np.asarray(js.keys),
                                  ts.keys.numpy().astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(js.values), ts.values.numpy())
    np.testing.assert_array_equal(np.asarray(js.valid), ts.valid.numpy())
    for a, b in zip(jrel.to_numpy(jrel.pad_to(jr, 4096)),
                    trel.to_numpy(trel.bucket_to_pow2(tr))):
        np.testing.assert_array_equal(a, b)
    assert trel.bucket_to_pow2(tr).capacity == jrel.bucket_capacity(n) == 4096


def test_synthetic_generators_match():
    j = jsyn.overlapping_relations([3000, 2000], 0.2, keys_per_dataset=300,
                                   seed=2)
    t = tsyn.overlapping_relations([3000, 2000], 0.2, keys_per_dataset=300,
                                   seed=2, device="cpu")
    j.append(jsyn.skewed_relation(2000, 100, seed=3))
    t.append(tsyn.skewed_relation(2000, 100, seed=3, device="cpu"))
    for a, b in zip(j, t):
        for x, y in zip(jrel.to_numpy(a), trel.to_numpy(b)):
            np.testing.assert_array_equal(x, y)
