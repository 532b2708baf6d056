"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card of compute capability 9.0 or more (the
kernels are built for sm_90a); elsewhere they skip.  They import neither JAX
nor ``repro``, so they run where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Filter words, membership masks and draw counts must be equal; the float sums
within rtol 1e-5 (atol 1e-3), because the kernel adds them in another order.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.bloom import num_blocks_for
from repro_torch.core.budget import QueryBudget
from repro_torch.core.join import approx_join
from repro_torch.core.relation import relation, sort_by_key
from repro_torch.core.sampling import build_strata
from repro_torch.kernels import bloom_build, bloom_probe, edge_sample

pytestmark = pytest.mark.cuda

SEEDS = (0, 2**32 - 1, 0x9E3779B1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


def _keys(B, n, seed, device):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 2**32, (B, n)).astype(np.int64),
                           device=device)


@pytest.mark.parametrize("B,n", [(1, 1), (1, 5000), (3, 70001)])
def test_build_and_hashes_match_plain(card, B, n):
    keys = _keys(B, n, n, card)
    valid = torch.as_tensor(np.random.default_rng(B).random((B, n)) > 0.2,
                            device=card)
    seeds = torch.tensor(SEEDS[:B], device=card)
    nb = num_blocks_for(n, 0.01)
    words = bloom_build.bloom_build_batched(keys, valid, nb, seeds)
    torch.cuda.synchronize()
    assert torch.equal(words.cpu(), bloom_build.bloom_build_ref(
        keys.cpu(), valid.cpu(), nb, seeds.cpu()))
    blk, masks = bloom_build.bloom_hashes_batched(keys, seeds, nb)
    rblk, rmasks = bloom_build.bloom_hashes_ref(keys, nb, seeds)
    assert torch.equal(blk, rblk) and torch.equal(masks, rmasks)


@pytest.mark.parametrize("B,n", [(1, 3), (3, 40000)])
def test_probe_matches_plain(card, B, n):
    seeds = torch.tensor(SEEDS[:B], device=card)
    built = _keys(B, n, 1, card)
    nb = num_blocks_for(n, 0.05)
    words = bloom_build.bloom_build_batched(
        built, torch.ones_like(built, dtype=torch.bool), nb, seeds)
    probe = torch.cat([built, _keys(B, n, 2, card)], dim=1)
    got = bloom_probe.bloom_probe_batched(words, probe, seeds)
    assert torch.equal(got, bloom_probe.bloom_probe_ref(words, probe, seeds))
    assert bool(got[:, :n].all())


@pytest.mark.parametrize("expr", ["sum", "product"])
def test_edge_sample_matches_plain(card, expr):
    rng = np.random.default_rng(5)
    B, S, b_max = 3, 700, 300
    cols = []
    for b in range(B):
        rels = [relation(rng.integers(lo, hi, 20000).astype(np.uint32),
                         rng.normal(mu, 2, 20000).astype(np.float32),
                         device=card)
                for lo, hi, mu in ((0, 600, 10.0), (300, 1000, 5.0))]
        srt = [sort_by_key(r) for r in rels]
        st = build_strata(srt, S)
        b_i = torch.as_tensor(rng.uniform(0, 400, S).astype(np.float32),
                              device=card)
        cols.append((srt[0].values, srt[1].values, st.keys, st.starts[0],
                     st.counts[0], st.starts[1], st.counts[1], st.joinable,
                     b_i))
    args = [torch.stack(c) for c in zip(*cols)]
    seeds = torch.tensor(SEEDS, device=card)
    got = edge_sample.edge_sample_batched(*args, seeds, b_max, expr)
    want = edge_sample.edge_sample_ref(*args, b_max, seeds, expr)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-3)
    for b in range(B):  # a batch equals its slots one by one
        one = edge_sample.edge_sample_batched(*(a[b:b + 1] for a in args),
                                              seeds[b:b + 1], b_max, expr)
        assert all(torch.equal(x[b:b + 1], y) for x, y in zip(got, one))


def test_approx_join_on_card_matches_cpu(card):
    rng = np.random.default_rng(7)
    arrs = [(rng.integers(lo, hi, 30000).astype(np.uint32),
             rng.normal(mu, 2, 30000).astype(np.float32))
            for lo, hi, mu in ((0, 2000, 10.0), (1500, 4000, 5.0))]
    on = [relation(k, v) for k, v in arrs]
    off = [relation(k, v, device="cpu") for k, v in arrs]
    launches = edge_sample.edge_sample_batched.launches
    for budget in (QueryBudget(), QueryBudget(error=0.5)):
        kw = dict(seed=3, max_strata=4096, b_max=256)
        g = approx_join(on, budget, use_kernels=True, **kw)
        c = approx_join(off, budget, use_kernels=True, **kw)
        torch.testing.assert_close(g.estimate.cpu(), c.estimate, rtol=1e-4,
                                   atol=0)
        torch.testing.assert_close(g.error_bound.cpu(), c.error_bound,
                                   rtol=1e-4, atol=1e-6)
        assert float(g.count) == float(c.count)
    assert edge_sample.edge_sample_batched.launches > launches


def test_wrappers_raise_on_what_the_kernel_does_not_take(card):
    keys = _keys(1, 10, 0, card)
    with pytest.raises(ValueError, match="int64"):
        bloom_build.bloom_build_batched(keys.int(), keys > 0, 64,
                                        torch.zeros(1, dtype=torch.int64,
                                                    device=card))
    with pytest.raises(ValueError, match="power of 2"):
        bloom_probe.bloom_probe_batched(
            torch.zeros((1, 3, 8), dtype=torch.int32, device=card), keys,
            torch.zeros(1, dtype=torch.int64, device=card))
