"""The plain reference against a brute-force join and against the program's
own definitions, on the CPU at a tiny size."""

from __future__ import annotations

import math
from collections import Counter

import pytest
import torch

from portbench.reference import join as ref

SEED = 2**31 + 4242


def _pair(n0=600, n1=500, keys=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    k0 = torch.randint(0, keys, (n0,), generator=g) * 7919 + 3
    k1 = torch.randint(keys // 2, keys + keys // 2, (n1,), generator=g) \
        * 7919 + 3
    v0 = torch.randint(0, 50, (n0,), generator=g).float() / 4
    v1 = torch.randint(0, 50, (n1,), generator=g).float() / 4
    return [(k0, v0), (k1, v1)]


def test_exact_sum_and_strata_equal_a_brute_force_join():
    rels = _pair()
    p = ref.prepare(rels, fp_rate=0.01, max_strata=128, filter_seed=SEED)
    (k0, v0), (k1, v1) = rels
    total, pairs = 0.0, 0
    for a, x in zip(k0.tolist(), v0.tolist()):
        for b, y in zip(k1.tolist(), v1.tolist()):
            if a == b:
                total += x + y
                pairs += 1
    assert p.truth == pytest.approx(total, rel=1e-12)
    assert float(p.population.sum()) == pairs
    c0, c1 = Counter(k0.tolist()), Counter(k1.tolist())
    both = sorted(set(c0) & set(c1))
    keys = p.keys[p.joinable].tolist()
    assert keys == both and p.num_strata == len(both)
    assert p.counts[:, p.joinable].tolist() == [[c0[k] for k in both],
                                                [c1[k] for k in both]]
    # a Bloom filter has no false negatives: every joining row is live
    assert p.live[0] >= sum(c0[k] for k in both)
    assert p.live[1] >= sum(c1[k] for k in both)
    # the strata are the first input's live keys, ascending, SENTINEL after
    lead = p.keys[p.valid]
    assert torch.all(lead[1:] > lead[:-1])
    assert torch.all(p.keys[~p.valid] == ref.SENTINEL)
    assert p.overflow == 0


def test_strata_past_the_capacity_are_counted_in_overflow():
    rels = _pair()
    kw = dict(fp_rate=0.01, filter_seed=SEED)
    n_live = int(ref.prepare(rels, max_strata=128, **kw).valid.sum())
    p = ref.prepare(rels, max_strata=8, **kw)
    assert int(p.valid.sum()) == 8 and p.overflow == n_live - 8 > 0


def test_filter_and_strata_equal_the_programs():
    """The reference's filter, live rows and strata, written from the
    definition, equal the program's plain stages bit for bit."""
    from repro_torch.core import bloom
    from repro_torch.core.join import prepare_stage
    from repro_torch.core.relation import relation
    rels = _pair(seed=3)
    cap = ref.pow2_at_least(max(k.shape[0] for k, _ in rels))
    nb = ref.num_blocks_for(cap, 0.01)
    assert nb == bloom.num_blocks_for(cap, 0.01)
    words = bloom.build(rels[0][0], torch.ones(rels[0][0].shape, dtype=bool),
                        nb, SEED).words
    bits = ((words.to(torch.int64) & ref.MASK)[..., None]
            >> torch.arange(32)) & 1
    assert torch.equal(ref.bloom_grid(rels[0][0], nb, SEED),
                       bits.reshape(-1).bool())
    p = ref.prepare(rels, fp_rate=0.01, max_strata=128, filter_seed=SEED)
    prog = prepare_stage([relation(k, v, device="cpu") for k, v in rels],
                         nb, 128, SEED)
    assert prog.live_counts.tolist() == p.live
    assert torch.equal(prog.strata.keys, p.keys)
    assert torch.equal(prog.strata.valid, p.valid)
    assert torch.equal(prog.strata.counts, p.counts)
    assert torch.equal(prog.strata.starts[:, p.valid], p.starts[:, p.valid])


def test_draws_and_estimate_equal_the_programs():
    from repro_torch.core.estimators import clt_sum
    from repro_torch.core.join import measured_sigma, prepare_stage
    from repro_torch.core.relation import relation
    from repro_torch.core.sampling import sample_edges
    rels = _pair(n0=2000, n1=1500, seed=5)
    p = ref.prepare(rels, fp_rate=0.01, max_strata=128, filter_seed=SEED)
    nb = ref.num_blocks_for(2048, 0.01)
    prog = prepare_stage([relation(k, v, device="cpu") for k, v in rels],
                         nb, 128, SEED)
    b_max, seed = 16, 977
    n = ref.pilot_draws(p, 0.5, b_max)
    assert 0 < int(n.max()) <= b_max and int(n[~p.joinable].sum()) == 0
    s = ref.sample(p, seed, n)
    out = sample_edges(prog.sorted_rels, prog.strata, n.float(), b_max,
                       ((seed & ref.MASK) + 1) & ref.MASK)
    assert torch.equal(out.stats.n_sampled.to(torch.int64), s.n)
    est = clt_sum(out.stats)
    assert s.estimate == pytest.approx(float(est.estimate), rel=1e-6)
    assert s.bound == pytest.approx(float(est.error_bound), rel=1e-5)
    assert torch.allclose(s.sigma[p.joinable].float(),
                          measured_sigma(out.stats)[p.joinable], rtol=1e-5)


def test_the_chain_sizes_each_request_by_the_last_sigmas():
    """Under an error budget the first request of a query id draws the
    pilot fraction and each later one Eq. 9/10 of its last one's sigmas, as
    the program's own rule does on the same sigmas."""
    from repro_torch.core.cost import sizes_for_error
    rels = _pair(n0=3000, n1=3000, keys=20, seed=6)
    p = ref.prepare(rels, fp_rate=0.01, max_strata=64, filter_seed=SEED)
    q = [{"agg": "sum", "expr": "sum", "budget": {"error": 2.0}}]
    sent = [{"query_id": "a", "dataset": 0, "query": 0, "seed": s}
            for s in (5, 6, 7)]
    first, second, third = ref.replay([p], q, sent, b_max=4096)
    assert torch.equal(first.n, ref.pilot_draws(p, 0.1, 4096))
    for last, now in ((first, second), (second, third)):
        want = sizes_for_error(2.0, last.sigma.float(), p.population.float())
        assert torch.equal(now.n, want.to(torch.int64))
        assert torch.equal(now.n, ref.error_draws(p, last.sigma, 2.0, 0.95,
                                                  4096))
    # another query id starts its own chain
    other = ref.replay([p], q, sent[:1] + [dict(sent[1], query_id="b")],
                       b_max=4096)[1]
    assert torch.equal(other.n, ref.pilot_draws(p, 0.1, 4096))


def test_exact_count_and_avg_equal_a_brute_force_join():
    rels = _pair(seed=4)
    p = ref.prepare(rels, fp_rate=0.01, max_strata=128, filter_seed=SEED)
    (k0, v0), (k1, v1) = rels
    pairs = [(x, y) for a, x in zip(k0.tolist(), v0.tolist())
             for b, y in zip(k1.tolist(), v1.tolist()) if a == b]
    total = sum(x + y for x, y in pairs)
    assert ref.exact(p, "count") == len(pairs)
    assert ref.exact(p, "avg") == pytest.approx(total / len(pairs), rel=1e-12)
    with pytest.raises(ValueError):
        ref.exact(p, "stdev")


def test_the_estimate_covers_the_truth_at_its_confidence():
    rels = _pair(n0=4000, n1=4000, keys=30, seed=9)
    p = ref.prepare(rels, fp_rate=0.01, max_strata=64, filter_seed=SEED)
    n = ref.pilot_draws(p, 1.0, 32)
    inside = sum(abs(s.estimate - p.truth) <= s.bound for s in
                 (ref.sample(p, seed, n) for seed in range(200)))
    assert 180 <= inside <= 200


def test_t_quantile_tends_to_the_normal():
    assert ref.t_quantile(0.975, 1e9) == pytest.approx(1.959964, abs=1e-6)
    assert ref.t_quantile(0.975, 10) == pytest.approx(2.228, abs=5e-3)
    assert math.isfinite(ref.t_quantile(0.975, 0.0))


def test_a_lower_precision_changes_the_answer():
    rels = _pair(seed=11)
    kw = dict(fp_rate=0.01, max_strata=128, filter_seed=SEED)
    hi, lo = ref.prepare(rels, **kw), ref.prepare(rels, dtype=torch.bfloat16,
                                                 **kw)
    assert hi.live == lo.live and torch.equal(hi.counts, lo.counts)
    assert abs(lo.truth - hi.truth) / abs(hi.truth) > 1e-5
