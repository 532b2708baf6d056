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
from repro_torch.kernels import _build, bloom_build, bloom_probe, edge_sample

pytestmark = pytest.mark.cuda

SEEDS = (0, 2**32 - 1, 0x9E3779B1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


def _keys(B, n, seed, device, kind="random"):
    """[B, n] int64 keys holding uint32 values: random, all distinct, or 16
    distinct values repeated (the contended case of the build)."""
    rng = np.random.default_rng(seed)
    if kind == "distinct":
        k = (np.arange(B * n, dtype=np.uint64) * 0x9E3779B1 + seed) % 2**32
    elif kind == "dup16":
        k = rng.integers(0, 2**32, 16)[rng.integers(0, 16, B * n)]
    else:
        k = rng.integers(0, 2**32, B * n)
    return torch.as_tensor(k.astype(np.int64).reshape(B, n), device=device)


# A warp of the build takes 64 consecutive rows of a slot, 4 keys a lane
# pair: (3, 70001) puts slots 1 and 2 on odd rows (keys off a 16-byte
# boundary), (2, 3) has n below 4.
@pytest.mark.parametrize("B,n,kind", [
    (1, 1, "random"), (1, 5000, "random"), (3, 70001, "random"),
    (2, 3, "random"), (1, 2**20, "dup16"), (2, 2**20 + 1, "distinct")])
def test_build_and_hashes_match_plain(card, B, n, kind):
    keys = _keys(B, n, n, card, kind)
    valid = torch.as_tensor(np.random.default_rng(B).random((B, n)) > 0.2,
                            device=card)
    seeds = torch.tensor(SEEDS[:B], device=card)
    nb = num_blocks_for(n, 0.01)
    words = bloom_build.bloom_build_batched(keys, valid, nb, seeds)
    torch.cuda.synchronize()
    assert torch.equal(words, bloom_build.bloom_build_ref(keys, valid, nb,
                                                          seeds))
    blk, masks = bloom_build.bloom_hashes_batched(keys, seeds, nb)
    rblk, rmasks = bloom_build.bloom_hashes_ref(keys, nb, seeds)
    assert torch.equal(blk, rblk) and torch.equal(masks, rmasks)


@pytest.mark.parametrize("B,n,kind", [
    (1, 3, "random"), (3, 40000, "random"), (3, 40001, "random"),
    (1, 2**20, "dup16"), (2, 2**20, "distinct")])
def test_probe_matches_plain(card, B, n, kind):
    seeds = torch.tensor(SEEDS[:B], device=card)
    built = _keys(B, n, 1, card, kind)
    nb = num_blocks_for(n, 0.05)
    words = bloom_build.bloom_build_batched(
        built, torch.ones_like(built, dtype=torch.bool), nb, seeds)
    probe = torch.cat([built, _keys(B, n, 2, card)], dim=1)
    got = bloom_probe.bloom_probe_batched(words, probe, seeds)
    assert torch.equal(got, bloom_probe.bloom_probe_ref(words, probe, seeds))
    assert bool(got[:, :n].all())


# (strata S, b_max, keys per side and rows) of each edge-sample case:
# mixed: overlapping key ranges, b_i uniform in [0, 400); bi_edges: b_i at
# the mask's edges; count1: every key of side 2 once; absent: side 1's upper
# keys missing from side 2 (start at its end); garbage: non-joinable strata
# with starts and counts pointing anywhere; full: every stratum draws b_max
# (the smoke's shape, smaller); zipf: Zipf(1.5) keys, pilot-sized b_i;
# odd / odd_big: b_max above one chunk and not a multiple of any; huge: a
# b_max that takes several rounds a chunk.
EDGE_CASES = {
    "mixed": (700, 300), "bi_edges": (700, 128), "count1": (700, 300),
    "absent": (700, 300), "garbage": (700, 300), "full": (200, 2048),
    "zipf": (4096, 2048), "odd": (1000, 2049), "odd_big": (1000, 5000),
    "huge": (64, 20000)}
BI_EDGES = (0.0, -1.0, -0.5, 0.3, 1.0, 7.0, 7.5, 127.0, 127.5, 128.0, 129.0,
            1e30, float("inf"), float("nan"))


def _edge_side(rng, case, side):
    """(uint32 keys, float32 values) of one side of a case."""
    if case == "zipf":
        k = np.minimum(rng.zipf(1.5, 1 << 17), 1 << 12) - 1
    elif case in ("full", "huge"):
        k = np.repeat(np.arange(EDGE_CASES[case][0]), 160)
    elif case == "count1" and side == 1:
        k = rng.permutation(np.arange(300, 1000))
    else:
        lo, hi = {"absent": ((300, 1000), (0, 700))}.get(
            case, ((0, 600), (300, 1000)))[side]
        k = rng.integers(lo, hi, 20000)
    v = rng.normal((10.0, 5.0)[side], 2, k.size)
    return k.astype(np.uint32), v.astype(np.float32)


def _edge_args(card, case, B=3):
    """The nine array operands of edge_sample, [B, ...] on the card."""
    rng = np.random.default_rng(5)
    S, b_max = EDGE_CASES[case]
    cols = []
    for b in range(B):
        srt = [sort_by_key(relation(*_edge_side(rng, case, side),
                                    device=card)) for side in (0, 1)]
        st = build_strata(srt, S)
        starts, counts = st.starts.clone(), st.counts.clone()
        if case == "garbage":
            junk = torch.as_tensor(rng.integers(0, 2**40, (2, S)),
                                   device=card)
            starts = torch.where(st.joinable, starts, junk)
            counts = torch.where(st.joinable, counts, junk.flip(0))
        if case == "bi_edges":
            b_i = np.asarray(BI_EDGES, np.float32)[
                rng.integers(0, len(BI_EDGES), S)]
        elif case in ("full", "zipf"):
            b_i = np.ceil(0.1 * st.population.cpu().numpy())
        else:
            b_i = rng.uniform(0, 400 * b_max / 300, S)
        b_i = torch.as_tensor(b_i.astype(np.float32), device=card)
        if case == "full":
            assert bool((b_i[st.joinable] >= b_max).all())
        cols.append((srt[0].values, srt[1].values, st.keys, starts[0],
                     counts[0], starts[1], counts[1], st.joinable, b_i))
    return [torch.stack(c) for c in zip(*cols)], b_max


def _edge_params():
    for case in EDGE_CASES:
        for expr in ("sum", "product"):
            yield pytest.param(case, expr,
                               id=expr if case == "mixed" else
                               f"{expr}-{case}")


@pytest.mark.parametrize("case,expr", _edge_params())
def test_edge_sample_matches_plain(card, case, expr):
    args, b_max = _edge_args(card, case)
    B = args[0].shape[0]
    seeds = torch.tensor(SEEDS, device=card)
    got = edge_sample.edge_sample_batched(*args, seeds, b_max, expr)
    again = edge_sample.edge_sample_batched(*args, seeds, b_max, expr)
    want = edge_sample.edge_sample_ref(*args, b_max, seeds, expr)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))  # deterministic
    assert torch.equal(got[0], want[0])
    assert float(got[0].sum()) > 0
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
    seed = torch.zeros(1, dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="power of 2"):
        bloom_probe.bloom_probe_batched(
            torch.zeros((1, 3, 8), dtype=torch.int32, device=card), keys, seed)
    # blocks 16 bytes off a 32-byte boundary would each span two sectors,
    # and the build commits lanes in 8-byte pairs
    flat = torch.zeros(64 * 8 + 4, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="32-byte aligned"):
        bloom_probe.bloom_probe_batched(flat[4:].view(1, 64, 8), keys, seed)
    with pytest.raises(ValueError, match="32-byte aligned"):
        _build.require_aligned("bloom_build", "words", flat[4:], 32)
    # n_sampled is exact only while every draw counter is a float32
    args, _ = _edge_args(card, "mixed", B=1)
    with pytest.raises(ValueError, match="b_max"):
        edge_sample.edge_sample_batched(*args, seed, 2**24 + 1)
