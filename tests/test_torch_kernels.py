"""PyTorch port vs the JAX package: the three kernels' plain PyTorch versions
(what a CPU tensor runs) against the Pallas kernels in interpret mode, at
B = 1 and at B = 3 with mixed seeds.

Integer outputs (block indices, lane masks, filter words, membership masks,
draw counts) must be equal; the float sums within rtol 1e-5, because they add
in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.bloom_build import bloom_hashes_batched as j_hashes
from repro.kernels.bloom_probe import bloom_probe_batched as j_probe
from repro.kernels.edge_sample import edge_sample_batched as j_edge
from repro_torch.core import bloom as tbloom
from repro_torch.core.relation import relation, sort_by_key
from repro_torch.core.sampling import build_strata
from repro_torch.kernels import bloom_build, bloom_probe, edge_sample
from repro_torch.kernels import ops as tops

SEEDS = (0, 2**32 - 1, 0x9E3779B1)


def _keys(B, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (B, n), dtype=np.uint32)


def _t(a):
    """numpy -> CPU torch (uint32 keys become int64)."""
    a = np.asarray(a)
    if a.dtype in (np.uint32, np.int32):
        a = a.astype(np.int64)
    return torch.as_tensor(a)


def _words_np(w):
    return w.numpy().view(np.uint32)


@pytest.mark.parametrize("B", [1, 3])
def test_bloom_hashes_plain_matches_pallas(B):
    keys = _keys(B, 2048, B)
    seeds = np.asarray(SEEDS[:B], np.uint32)
    nb = 1 << 10
    jblk, jmasks = j_hashes(jnp.asarray(keys), jnp.asarray(seeds), nb,
                            interpret=True)
    tblk, tmasks = bloom_build.bloom_hashes_batched(_t(keys), _t(seeds), nb)
    np.testing.assert_array_equal(np.asarray(jblk), tblk.numpy())
    np.testing.assert_array_equal(np.asarray(jmasks).astype(np.int64),
                                  tmasks.numpy())


# 8192 rows over 16 keys: the repeated keys the CUDA build is designed for
@pytest.mark.parametrize("B,n,n_keys", [
    pytest.param(1, 3000, None, id="1-3000"),
    pytest.param(3, 2048, None, id="3-2048"),
    pytest.param(1, 8192, 16, id="1-8192-16keys")])
def test_build_filter_plain_matches_pallas(B, n, n_keys):
    keys = _keys(B, n, 10 + B)
    if n_keys:
        keys = _keys(1, n_keys, n)[0][
            np.random.default_rng(n).integers(0, n_keys, (B, n))]
    valid = np.random.default_rng(B).random((B, n)) > 0.25
    seeds = np.asarray(SEEDS[:B], np.uint32)
    nb = tbloom.num_blocks_for(n, 0.01)
    want = jops.build_filter_batched(jnp.asarray(keys), jnp.asarray(valid), nb,
                                     jnp.asarray(seeds), interpret=True)
    got = tops.build_filter_batched(_t(keys), _t(valid), nb, _t(seeds))
    np.testing.assert_array_equal(np.asarray(want), _words_np(got))
    # the B = 1 shim, and no launch for CPU tensors
    before = bloom_build.bloom_build_batched.launches
    one = tops.build_filter(_t(keys[0]), _t(valid[0]), nb, int(seeds[0]))
    np.testing.assert_array_equal(np.asarray(want[0]), one.to_numpy())
    assert bloom_build.bloom_build_batched.launches == before


@pytest.mark.parametrize("B", [1, 3])
def test_probe_plain_matches_pallas(B):
    n = 2048
    seeds = np.asarray(SEEDS[:B], np.uint32)
    built = _keys(B, n, 20 + B)
    nb = tbloom.num_blocks_for(n, 0.05)
    words = jops.build_filter_batched(jnp.asarray(built),
                                      jnp.ones((B, n), bool), nb,
                                      jnp.asarray(seeds), interpret=True)
    probe = np.concatenate([built[:, : n // 2], _keys(B, n // 2, 30)], axis=1)
    want = j_probe(words, jnp.asarray(probe), jnp.asarray(seeds),
                   interpret=True)
    tw = torch.as_tensor(np.asarray(words).view(np.int32))
    got = bloom_probe.bloom_probe_batched(tw, _t(probe), _t(seeds))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got.numpy()[:, : n // 2].all()  # no false negatives
    # ragged length through the ops wrapper, and the B = 1 shim
    wantr = jops.probe_filter_batched(words, jnp.asarray(probe[:, :1500]),
                                      jnp.asarray(seeds), interpret=True)
    gotr = tops.probe_filter_batched(tw, _t(probe[:, :1500]), _t(seeds))
    np.testing.assert_array_equal(np.asarray(wantr), gotr.numpy())
    np.testing.assert_array_equal(
        np.asarray(wantr[0]),
        tops.probe_filter(tw[0], _t(probe[0, :1500]), int(seeds[0])).numpy())


def _strata_operands(B, S, seed):
    """Per-slot sorted values + strata from real relations, padded to S
    strata: some joinable, some present on one side only (start at the
    side's end), b_i fractional, above and below b_max."""
    rng = np.random.default_rng(seed)
    cols = {k: [] for k in ("v1", "v2", "keys", "s1", "c1", "s2", "c2",
                            "join", "bi")}
    for b in range(B):
        rels = [relation(rng.integers(lo, hi, 1500).astype(np.uint32),
                         rng.normal(mu, 2, 1500).astype(np.float32),
                         device="cpu")
                for lo, hi, mu in ((0, 150, 10.0), (100, 260, 5.0))]
        srt = [sort_by_key(r) for r in rels]
        st = build_strata(srt, S)
        cols["v1"].append(srt[0].values.numpy())
        cols["v2"].append(srt[1].values.numpy())
        cols["keys"].append(st.keys.numpy().astype(np.uint32))
        cols["s1"].append(st.starts[0].numpy().astype(np.int32))
        cols["c1"].append(st.counts[0].numpy().astype(np.int32))
        cols["s2"].append(st.starts[1].numpy().astype(np.int32))
        cols["c2"].append(st.counts[1].numpy().astype(np.int32))
        cols["join"].append(st.joinable.numpy())
        cols["bi"].append(np.round(rng.uniform(0, 200, S), 1)
                          .astype(np.float32))
    return {k: np.stack(v) for k, v in cols.items()}


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("expr", ["sum", "product"])
def test_edge_sample_plain_matches_pallas(B, expr):
    S, b_max = 256, 128
    o = _strata_operands(B, S, 40 + B)
    assert (~o["join"]).any() and o["join"].any()
    seeds = np.asarray(SEEDS[:B], np.uint32)
    names = ("v1", "v2", "keys", "s1", "c1", "s2", "c2", "join", "bi")
    want = j_edge(*(jnp.asarray(o[k]) for k in names), jnp.asarray(seeds),
                  b_max, expr, interpret=True)
    got = edge_sample.edge_sample_batched(*(_t(o[k]) for k in names),
                                          _t(seeds), b_max, expr)
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_allclose(np.asarray(w), g.numpy(), rtol=1e-5,
                                   atol=1e-3)
    # ragged strata count through the ops wrappers (StratumStats)
    Sr = 200
    cut = {k: (o[k] if k in ("v1", "v2") else o[k][:, :Sr]) for k in names}
    starts = np.stack([cut["s1"], cut["s2"]], axis=1)
    counts = np.stack([cut["c1"], cut["c2"]], axis=1)
    pop = np.zeros((B, Sr), np.float32)
    jst = jops.sample_stats_batched(
        *(jnp.asarray(x) for x in (cut["v1"], cut["v2"], cut["keys"], starts,
                                   counts, cut["join"], pop, cut["bi"],
                                   seeds)), b_max, expr, interpret=True)
    tst = tops.sample_stats_batched(
        *(_t(x) for x in (cut["v1"], cut["v2"], cut["keys"], starts, counts,
                          cut["join"], pop, cut["bi"], seeds)), b_max, expr)
    np.testing.assert_array_equal(np.asarray(jst.n_sampled),
                                  tst.n_sampled.numpy())
    np.testing.assert_allclose(np.asarray(jst.sum_f), tst.sum_f.numpy(),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(jst.sum_f2), tst.sum_f2.numpy(),
                               rtol=1e-5, atol=1e-3)


def test_edge_sample_single_slot_shim_matches_batched():
    o = _strata_operands(1, 128, 7)
    starts = np.stack([o["s1"], o["s2"]], axis=1)
    counts = np.stack([o["c1"], o["c2"]], axis=1)
    pop = np.ones_like(o["bi"])
    batched = tops.sample_stats_batched(
        *(_t(x) for x in (o["v1"], o["v2"], o["keys"], starts, counts,
                          o["join"], pop, o["bi"])), _t(np.asarray([5])), 64)
    single = tops.sample_stats_2way(
        *(_t(x[0]) for x in (o["v1"], o["v2"], o["keys"], starts, counts,
                             o["join"], pop, o["bi"])), 64, seed=5)
    for a, b in zip(batched, single):
        assert torch.equal(a[0], b)


def test_wrappers_reject_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="expr"):
        edge_sample.edge_sample_batched(*([torch.zeros(1, 1)] * 9),
                                        torch.zeros(1), 8, "max")
