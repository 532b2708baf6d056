"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card of compute capability 9.0 or more (the
kernels are built for sm_90a); elsewhere they skip.  They import neither JAX
nor ``repro``, so they run where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Filter words, membership masks and draw counts must be equal; the float sums
within rtol 1e-5 (atol 1e-3), because the kernel adds them in another order.
The model stack's cases (which run no kernel of the port) hold a reduced
config of each family on the card against the CPU and its decode against
its forward.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.bloom import num_blocks_for
from repro_torch.core.budget import QueryBudget
from repro_torch.core.join import approx_join
from repro_torch.core.plan import Plan, PlanNode
from repro_torch.core.relation import Relation, relation, sort_by_key
from repro_torch.core.sampling import (build_strata, per_stratum_value_sums,
                                       reservoir_empty, reservoir_extend,
                                       reservoir_merge)
from repro_torch.core.window import WindowSpec
from repro_torch.kernels import _build, bloom_build, bloom_probe, edge_sample
from repro_torch.runtime import join_serve
from repro_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.runtime.join_serve import (JoinRequest, JoinServer,
                                            ShapeClass, slot_bytes)
from repro_torch.runtime.stream_join import StreamJoinServer

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


# -- the JoinServer on the card ----------------------------------------------

SERVE_N = 1 << 15
SERVE = dict(max_strata=4096, b_max=256, use_kernels=True)
COUNTERS = (bloom_build.bloom_build_batched, bloom_probe.bloom_probe_batched,
            edge_sample.edge_sample_batched)


def _serve_rels(card, values="poisson"):
    """Two relations of SERVE_N rows with Poisson values, as the paper's
    workloads have, whose sums are whole numbers and exact in float32; or
    normal ones, whose float32 sums depend on the order they are added
    in."""
    rng = np.random.default_rng(11)
    draw = {"poisson": lambda: rng.poisson(10, SERVE_N),
            "normal": lambda: rng.normal(10, 3, SERVE_N)}[values]
    return [relation(rng.integers(lo, hi, SERVE_N).astype(np.uint32),
                     draw().astype(np.float32), device=card)
            for lo, hi in ((0, 3000), (2000, 5000))]


def _fields(res):
    return [float(getattr(res, f))
            for f in ("estimate", "error_bound", "count", "dof")]


def _served_equals_direct(q, rels):
    d = approx_join(rels, q.budget, seed=q.seed, **SERVE)
    assert _fields(q.result) == _fields(d), q.query_id
    if d.stats is not None:
        for f in ("n_sampled", "sum_f", "sum_f2"):
            assert torch.equal(getattr(q.result.stats, f),
                               getattr(d.stats, f)), (q.query_id, f)


@pytest.mark.parametrize("values", ["poisson", "normal"])
def test_join_server_batch_equals_direct_calls(card, values):
    """One step of B = 4 mixed seeds (0xFFFFFFFF among them, an exact
    request too) on the card: every slot equal bit for bit to its own
    approx_join(use_kernels=True), with whole-number and with fractional
    values."""
    rels = _serve_rels(card, values)
    srv = JoinServer(batch_slots=4)
    srv.register_dataset("ds", rels)
    budgets = [QueryBudget(error=0.5)] * 3 + [QueryBudget()]
    qs = [srv.submit(JoinRequest(dataset="ds", budget=b, query_id=f"t{i}",
                                 seed=s, **SERVE))
          for i, (s, b) in enumerate(zip((3, 2**32 - 1, 3, 250), budgets))]
    assert srv.step() == 4
    for q in qs:
        _served_equals_direct(q, rels)
    assert srv.diagnostics.kernel_queries == 4


@pytest.mark.parametrize("n_keys", [16, 4096])
def test_exact_value_sums_deterministic_on_card(card, n_keys):
    """The exact stage's per-stratum value sums over 2^22 rows a side of
    normal float values: the same bits on every call, and within rtol 1e-4
    of a float64 sum on the host (a float32 sum of up to 2^18 rows a
    stratum, added in turn, rounds by about 2e-5)."""
    n = 1 << 22
    rng = np.random.default_rng(n_keys)
    rels = [sort_by_key(relation(
        rng.integers(0, n_keys, n).astype(np.uint32),
        rng.normal(10, 3, n).astype(np.float32), device=card))
        for _ in range(2)]
    strata = build_strata(rels, n_keys)
    runs = [per_stratum_value_sums(rels, strata) for _ in range(8)]
    distinct = sum(not torch.equal(r, runs[0]) for r in runs[1:])
    assert distinct == 0, f"{distinct} of 7 repeats differ from the first"
    for side, r in enumerate(rels):
        k = r.keys.cpu().numpy()
        want = np.bincount(k, weights=r.values.cpu().numpy().astype(np.float64),
                           minlength=n_keys)
        got = runs[0][side].cpu().numpy()
        order = strata.keys.cpu().numpy()[:n_keys]
        np.testing.assert_allclose(got, want[order], rtol=1e-4)


@pytest.mark.parametrize("n,share", [(2**24 + 3, 0.11), (2**22, 1.0),
                                     (4096, 0.0), (1, 1.0)])
def test_sort_by_key_on_card_is_the_int64_argsort(card, n, share):
    """Given its live count, ``sort_by_key`` waits for the device nowhere,
    and its rows are those of the stable int64 argsort of the masked keys,
    on the card and on the CPU: keys on both sides of 2^31, each live key
    held by about 256 rows."""
    rng = np.random.default_rng(n)
    edges = np.array([0, 2**31 - 1, 2**31, 2**32 - 2])
    pool = np.append(rng.integers(0, 2**32 - 1, max(n >> 8, 1)), edges)
    valid = rng.random(n) < share
    rel = relation(rng.choice(pool, n).astype(np.uint32),
                   rng.normal(0, 1, n).astype(np.float32), valid,
                   device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sort_by_key(rel, int(valid.sum()))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    order = torch.argsort(rel.masked_keys(), stable=True)
    on_cpu = sort_by_key(Relation(*(f.cpu() for f in rel)))
    for x, f, y in zip(got, rel, on_cpu):
        assert torch.equal(x, f[order])
        assert torch.equal(x.cpu(), y)


def test_join_server_launches_once_per_step_and_stage(card):
    """A step of any width launches the probe once per input and the
    sampler at most once; the build launches once per filter-cache miss."""
    rels = _serve_rels(card)
    srv = JoinServer(batch_slots=4)
    srv.register_dataset("ds", rels)

    def counts():
        return [c.launches for c in COUNTERS]

    def serve(k, budget, tag):
        before = counts()
        for i in range(k):
            srv.submit(JoinRequest(dataset="ds", budget=budget,
                                   query_id=f"{tag}{i}", seed=i,
                                   filter_seed=7, **SERVE))
        assert srv.step() == k
        return [a - b for a, b in zip(counts(), before)]

    # the first step of a width also warms its fresh prepare stage
    assert serve(4, QueryBudget(error=0.5), "w") == [2, 4, 1]
    assert srv.diagnostics.filter_builds == 2
    for k, budget, want in ((4, QueryBudget(error=0.5), [0, 2, 1]),
                            (3, QueryBudget(error=0.5), [0, 2, 1]),
                            (4, QueryBudget(), [0, 2, 0])):
        assert serve(k, budget, f"k{k}{want[2]}") == want
    assert srv.diagnostics.filter_builds == 2
    # every request after the first finds both inputs' words cached
    assert srv.diagnostics.filter_cache_hits == 2 * (3 + 4 + 3 + 4)


def test_join_server_slot_cap_binds_on_card(card, monkeypatch):
    """With the memory share cut to three slots' worth of the card, a
    kernel class serves in batches of two, each slot still equal bit for
    bit to its direct call."""
    rels = _serve_rels(card)
    cls = ShapeClass((SERVE_N, SERVE_N), 2, SERVE["max_strata"],
                     SERVE["b_max"], "sum", "sum", False, True, 0.01, 0.95)
    total = torch.cuda.get_device_properties(card).total_memory
    monkeypatch.setattr(join_serve, "SLOT_MEMORY_SHARE",
                        3 * slot_bytes(cls) / total)
    srv = JoinServer(batch_slots=4)
    qs = [srv.submit(JoinRequest(rels=rels, budget=QueryBudget(error=0.5),
                                 query_id=f"t{i}", seed=i, **SERVE))
          for i in range(4)]
    assert qs[0]._class == cls
    srv.run()
    assert srv.diagnostics.max_batch == 2 and srv.diagnostics.steps == 2
    for q in qs:
        _served_equals_direct(q, rels)


STREAM_ROWS = 1 << 14
STREAM = dict(budget=QueryBudget(error=0.5), max_strata=4096, b_max=256,
              seed=5, use_kernels=True)
STREAM_SPEC = WindowSpec(size=4, slide=1, sub_rows=STREAM_ROWS)


def _stream(card, seed, ticks=6):
    """Two inputs of ``ticks`` micro-batches each, normal float values (whose
    float32 sums depend on the order they are added in), as views of one
    relation a side."""
    rng = np.random.default_rng(seed)
    n = ticks * STREAM_ROWS
    rels = [relation(rng.integers(lo, hi, n).astype(np.uint32),
                     rng.normal(10, 3, n).astype(np.float32), device=card)
            for lo, hi in ((0, 3000), (2000, 5000))]
    cut = [[Relation(*(f[m * STREAM_ROWS:(m + 1) * STREAM_ROWS] for f in r))
            for r in rels] for m in range(ticks)]
    return rels, cut


def _stream_windows(card):
    """Two sliding sessions on one StreamJoinServer(batch_slots=2), their
    windows served two a step; returns ({name: (whole inputs, served
    windows)}, the server)."""
    srv = StreamJoinServer(batch_slots=2)
    streams = {name: _stream(card, seed) for name, seed in (("a", 1),
                                                            ("b", 2))}
    sess = {name: srv.open_stream(name, STREAM_SPEC, **STREAM)
            for name in streams}
    done = {name: [] for name in streams}
    for m in range(6):
        for name, (_, cut) in streams.items():
            sess[name].push(cut[m])
        srv.run()
        for name in streams:
            done[name] += sess[name].drain()
    assert srv.diagnostics.max_batch == 2
    return {name: (streams[name][0], done[name]) for name in streams}, srv


def _window_view(rels, w):
    lo = w * STREAM_SPEC.slide * STREAM_ROWS
    return [Relation(*(f[lo:lo + STREAM_SPEC.size * STREAM_ROWS] for f in r))
            for r in rels]


def test_stream_windows_equal_reregistered_baseline_on_card(card):
    """Every window of two sliding sessions served two a step on the card
    equals, bit for bit (estimate, bound, count, dof and the per-stratum
    sums), the same window's rows registered as a dataset on a fresh
    JoinServer(batch_slots=1) and queried with the session's query id,
    seeds and budget in window order."""
    served, _ = _stream_windows(card)
    base = JoinServer(batch_slots=1)
    for name, (rels, done) in served.items():
        assert [r.window_id for r in done] == [0, 1, 2]
        for r in done:
            w = r.window_id
            base.register_dataset(f"{name}{w}", _window_view(rels, w))
            q = base.submit(JoinRequest(
                dataset=f"{name}{w}", budget=STREAM["budget"],
                query_id=f"{name}/stream", seed=STREAM["seed"] + 1 + w,
                filter_seed=STREAM["seed"], max_strata=STREAM["max_strata"],
                b_max=STREAM["b_max"], use_kernels=True))
            base.run()
            assert _fields(r.result) == _fields(q.result), (name, w)
            for f in ("n_sampled", "sum_f", "sum_f2"):
                assert torch.equal(getattr(r.result.stats, f),
                                   getattr(q.result.stats, f)), (name, w, f)


def test_stream_window_words_equal_fresh_build_on_card(card):
    """A window's words, the OR of its sub-windows' cached builds, equal a
    fresh bloom_build over the window's rows bit for bit; each sub-window
    was built once a side, and the builds launched the build kernel."""
    before = bloom_build.bloom_build_batched.launches
    served, srv = _stream_windows(card)
    assert bloom_build.bloom_build_batched.launches - before \
        == srv.diagnostics.filter_builds == 2 * 2 * 6
    nb = num_blocks_for(STREAM_SPEC.size * STREAM_ROWS, 0.01)
    seeds = torch.tensor([STREAM["seed"]], device=card)
    for rels, done in served.values():
        for r in done:
            for side, rel in enumerate(_window_view(rels, r.window_id)):
                fresh = bloom_build.bloom_build_batched(
                    rel.keys[None].contiguous(), rel.valid[None].contiguous(),
                    nb, seeds)[0]
                assert torch.equal(r._words[side], fresh), (r.window_id, side)


def test_stream_reservoir_on_card_equals_cpu(card):
    """A session's reservoirs folded on the card equal the same folds of CPU
    copies bit for bit (priorities, values, n_seen), as does a fold of a
    batch with invalid rows and a merge whose priorities all tie."""
    served, srv = _stream_windows(card)
    sess = srv.sessions["a"]
    rels, _ = served["a"]
    cpu = [reservoir_empty(sess.sketch_strata, sess.sketch_cap, device="cpu")
           for _ in range(2)]
    for m in range(6):
        for side, r in enumerate(rels):
            part = [f[m * STREAM_ROWS:(m + 1) * STREAM_ROWS].cpu() for f in r]
            cpu[side] = reservoir_extend(cpu[side], *part, sess.filter_seed, m)
    for side in range(2):
        for got, want in zip(sess.sketch[side], cpu[side]):
            assert torch.equal(got.cpu(), want), side
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**32, 1 << 18)
    vals = rng.normal(0, 1, 1 << 18).astype(np.float32)
    valid = rng.random(1 << 18) > 0.3
    outs = []
    for dev in (card, "cpu"):
        res = reservoir_extend(
            reservoir_empty(128, 64, device=dev),
            torch.as_tensor(keys, device=dev), torch.as_tensor(vals, device=dev),
            torch.as_tensor(valid, device=dev), 0xFFFFFFFF, 7)
        outs.append(reservoir_merge(res, res))
    for got, want in zip(*outs):
        assert torch.equal(got.cpu(), want)


# -- plans and crash safety on the card ----------------------------------------

def _plan_server(card):
    """A JoinServer(batch_slots=4) on the card with three registered
    datasets of SERVE_N rows (normal float values)."""
    rng = np.random.default_rng(21)
    srv = JoinServer(batch_slots=4)
    for name, (lo, hi) in zip("abc", ((0, 3000), (1000, 4000), (2000, 5000))):
        srv.register_dataset(name, [relation(
            rng.integers(lo, hi, SERVE_N).astype(np.uint32),
            rng.normal(10, 3, SERVE_N).astype(np.float32), device=card)])
    return srv


def test_plan_two_and_three_way_nodes_equal_composed_calls(card):
    """A plan with a 2-way node and a 3-way node on the kernel route equals
    the composed direct approx_join(use_kernels=True) calls bit for bit;
    the 2-way node samples through the kernel, the 3-way node with plain
    torch after the kernel build and probe."""
    srv = _plan_server(card)
    err = QueryBudget(error=0.5)
    plan = Plan((PlanNode("ab", ("a", "b"), budget=err, use_kernels=True,
                          max_strata=SERVE["max_strata"],
                          b_max=SERVE["b_max"]),
                 PlanNode("abc", ("ab", "c"), budget=err, use_kernels=True,
                          max_strata=SERVE["max_strata"],
                          b_max=SERVE["b_max"])))
    before = [c.launches for c in COUNTERS]
    handle = srv.submit_plan(plan, query_id="p", seed=5)
    srv.run()
    build, probe, sample = (c.launches - b for c, b in zip(COUNTERS, before))
    assert handle.done and srv.diagnostics.steps == 2
    assert build == 3 and sample == 1
    # each step probes once per input, and once more as it warms its stage
    assert probe == 2 * (2 + 3)
    for name, leaves in (("ab", "ab"), ("abc", "abc")):
        rels = [r for d in leaves for r in srv.datasets[d]]
        d = approx_join(rels, err, seed=5, query_id=f"p/{name}", **SERVE)
        got = handle.results()[name]
        assert _fields(got) == _fields(d), name
        for f in ("n_sampled", "sum_f", "sum_f2"):
            assert torch.equal(getattr(got.stats, f), getattr(d.stats, f)), f


def test_snapshot_checkpoint_restore_on_card(card, tmp_path):
    """A kernel-route JoinServer's snapshot, written and loaded through a
    checkpoint and restored into a fresh server on the card: the filter
    words equal the originals bit for bit, and the next sampled results
    (sigma-fed) equal the uninterrupted server's."""
    src = _plan_server(card)
    err = QueryBudget(error=0.5)

    src.register_dataset("ab", src.datasets["a"] + src.datasets["b"])
    src.submit(JoinRequest(dataset="ab", budget=err, query_id="t/ab", seed=1,
                           **SERVE))
    src.run()
    queued = src.submit(JoinRequest(dataset="ab", budget=err,
                                    query_id="t/ab", seed=2, **SERVE))
    flat, meta = src.snapshot_state()
    save_checkpoint(str(tmp_path), 0, flat, extra=meta)
    flat2, meta2 = load_checkpoint(str(tmp_path), 0)
    dst = JoinServer(batch_slots=4)
    restored = dst.restore_state(flat2, meta2)
    on_card = torch.device(card).type
    assert len(restored) == 1
    assert restored[0].rels[0].keys.device.type == on_card
    assert list(dst._filter_words) == list(src._filter_words)
    for k, w in src._filter_words.items():
        assert dst._filter_words[k].device.type == on_card
        assert torch.equal(dst._filter_words[k], w)
    assert dst.sigma.table == src.sigma.table
    src.run()
    dst.run()
    assert _fields(restored[0].result) == _fields(queued.result)
    # the next request of the same id on each: sigma-fed, cached words
    nxt = [srv.submit(JoinRequest(dataset="ab", budget=err, query_id="t/ab",
                                  seed=3, **SERVE)) for srv in (src, dst)]
    src.run()
    dst.run()
    assert dst.diagnostics.filter_builds == src.diagnostics.filter_builds
    assert _fields(nxt[0].result) == _fields(nxt[1].result)
    for f in ("n_sampled", "sum_f", "sum_f2"):
        assert torch.equal(getattr(nxt[0].result.stats, f),
                           getattr(nxt[1].result.stats, f)), f


# -- the mesh on the card: NCCL at mesh 1, 2 ranks sharing the card over
# -- gloo (NCCL refuses two ranks on one card), and NCCL a card a rank on a
# -- machine of as many cards ----------------------------------------------
MESH_N = 1 << 14
MESH_JOINS = [dict(mode="exact", max_strata=4096, seed=7),
              dict(mode="sample", budget=QueryBudget(error=0.5), b_max=256,
                   max_strata=4096, seed=5),
              dict(mode="sample", budget=QueryBudget(error=0.5), b_max=256,
                   max_strata=4096, seed=5, merge="psum")]
MESH_SCRIPT = [({"batch_slots": 2}, [
    [{"query_id": "a", "seed": 5, "budget": (None, 0.5), "max_strata": 4096,
      "b_max": 256},
     {"query_id": "x", "seed": 7, "budget": (), "max_strata": 4096,
      "b_max": 256},
     {"query_id": "a", "seed": 8, "budget": (None, 0.5), "max_strata": 4096,
      "b_max": 256}],
    [{"query_id": "k", "seed": 21, "budget": (None, 0.5), "max_strata": 4096,
      "b_max": 256, "use_kernels": True}]])]


MESH_WORLDS = [(1, "nccl"), (2, "gloo"), (2, "nccl"), (4, "nccl")]


def _mesh_cards(world, backend):
    if backend == "nccl" and torch.cuda.device_count() < world:
        pytest.skip(f"NCCL a card a rank needs {world} cards")


def _mesh_data():
    rng = np.random.default_rng(3)
    return [(rng.integers(lo, hi, MESH_N).astype(np.uint32),
             rng.normal(mu, 2, MESH_N).astype(np.float32),
             rng.random(MESH_N) > 0.1)
            for lo, hi, mu in ((0, 900, 10.0), (600, 1500, 5.0))]


@pytest.mark.parametrize("world,backend", MESH_WORLDS)
def test_mesh_join_on_card_equals_approx_join(card, tmp_path, world,
                                              backend):
    """distributed_approx_join on the card: the gather merge bit for bit
    with approx_join's plain route, the psum merge within rtol 1e-5; each
    rank's shuffled bytes what the data routes off it."""
    import torch_dist
    _mesh_cards(world, backend)
    data = _mesh_data()
    got = torch_dist.spawn(torch_dist.join_rank, world,
                           (data, [((world, 1), ("data",))], (),
                            MESH_JOINS), tmp_path,
                           device="cuda", backend=backend)
    rels = [relation(k, v, m, device=card) for k, v, m in data]
    for case, res in zip(MESH_JOINS, got[0][0]["joins"]):
        single = dict(max_strata=case["max_strata"], seed=case["seed"])
        if case["mode"] == "sample":
            single["b_max"] = case["b_max"]
        want = _fields(approx_join(rels, case.get("budget", QueryBudget()),
                                   **single))
        if case.get("merge") == "psum":
            assert np.allclose(res["surface"], want, rtol=1e-5, atol=0)
        else:
            assert tuple(res["surface"]) == tuple(want)
        assert res["overflow"] == 0
        assert res["per_rank"] == torch_dist.routed_bytes(
            data, world, case["seed"]).tolist()
    for r in got[1:]:
        assert [j["surface"] for j in r[0]["joins"]] \
            == [j["surface"] for j in got[0][0]["joins"]]


@pytest.mark.parametrize("world,backend", MESH_WORLDS)
def test_mesh_server_on_card_equals_meshless(card, tmp_path, world, backend):
    """A mesh JoinServer on the card equals the meshless one bit for bit,
    its kernel class served on rank 0 (gathered to it at 2 ranks)."""
    import torch_dist
    _mesh_cards(world, backend)
    data = _mesh_data()
    got = torch_dist.spawn(torch_dist.serve_rank, world, (data, MESH_SCRIPT),
                           tmp_path, device="cuda", backend=backend)[0][0]
    rels = [relation(k, v, m, device=card) for k, v, m in data]
    want = torch_dist.run_script(JoinServer, rels, MESH_SCRIPT)[0]
    assert [r[:5] for r in got["results"]] \
        == [r[:5] for r in want["results"]]
    assert got["sigma"] == want["sigma"]
    gathered = got["snaps"][-1]["kernel_gather_bytes"]
    assert (gathered == 0) if world == 1 else (gathered > 0)


# -- the rest of the mesh on the card: streams (plain and kernel route),
# -- plans, snapshots and the streaming drill on mesh servers ---------------
SLICE_SUB = 1 << 12


def _slice_batches(n_ticks, n=SLICE_SUB, seed=11):
    rng = np.random.default_rng(seed)
    return [[(rng.integers(lo, hi, n).astype(np.uint32),
              rng.normal(10, 3, n).astype(np.float32))
             for lo, hi in ((0, 3000), (2000, 5000))]
            for _ in range(n_ticks)]


SLICE_STREAMS = [dict(name=name, spec=(4, 1, SLICE_SUB), budget=(None, 0.5),
                      mode="exact-parity", kernels=kernels, ms=4096, bm=256,
                      seed=5, batches=_slice_batches(6))
                 for name, kernels in (("kern", True), ("plain", False))]
SLICE_PAIRS = [[(k, v, np.ones(len(k), bool)) for k, v in tick]
               for tick in _slice_batches(2, n=1 << 13, seed=12)]
SLICE_PLAN = [(k, v, np.ones(len(k), bool))
              for tick in _slice_batches(2, n=1 << 12, seed=13)
              for k, v in tick]
SLICE_DRILL = _slice_batches(6, n=256, seed=14)
_SLICE: dict = {}


def _slice_run(card, tmp_path, world, backend):
    """One spawn a mesh: every case of the slice on it (see
    ``torch_dist.card_rank``); the drill on meshes of more than 1 rank."""
    import torch_dist
    _mesh_cards(world, backend)
    key = (world, backend)
    if key not in _SLICE:
        _SLICE[key] = torch_dist.spawn(
            torch_dist.card_rank, world,
            (SLICE_STREAMS, SLICE_PLAN, SLICE_PAIRS, SLICE_DRILL,
             str(tmp_path / "ckpt"), 256, world > 1), tmp_path,
            device="cuda", backend=backend)[0]
    return _SLICE[key]


@pytest.mark.parametrize("world,backend", MESH_WORLDS)
def test_mesh_stream_on_card_equals_meshless(card, tmp_path, world,
                                             backend):
    """Sliding windows on mesh servers on the card, on the kernel route
    (the sub-window filters built by the build kernel on every rank and
    OR-merged, the windows served on rank 0) and as mesh classes, equal
    the meshless server's bit for bit."""
    import torch_dist
    got = _slice_run(card, tmp_path, world, backend)["streams"]
    before = [c.launches for c in COUNTERS]
    want = [torch_dist.stream_windows(StreamJoinServer(batch_slots=2), case,
                                      card) for case in SLICE_STREAMS]
    assert all(c.launches > b for c, b in zip(COUNTERS, before))
    for g, w in zip(got, want):
        assert len(g["windows"]) == len(w["windows"]) == 3
        for a, b in zip(g["windows"], w["windows"]):
            assert a["surface"] == b["surface"]
            assert np.array_equal(a["n_sampled"], b["n_sampled"])
            for x, y in zip(a["words"], b["words"]):
                assert np.array_equal(x, y)
        assert g["sigma"] == w["sigma"]
    assert got[0]["diag"]["kernel_queries"] == 3


@pytest.mark.parametrize("world,backend", MESH_WORLDS)
def test_mesh_plan_and_snapshot_on_card(card, tmp_path, world, backend):
    """A plan (plain, then on the kernel route) on a mesh server on the
    card equals the meshless server's node for node, with the same byte
    model; a loaded mesh server's snapshot restored into a meshless server
    on the card gives the same next results as the mesh server."""
    import torch_dist
    got = _slice_run(card, tmp_path, world, backend)
    want = torch_dist.serve_plan(JoinServer(batch_slots=4), SLICE_PLAN, 256,
                                 card)
    for g, w in zip(got["plan"]["nodes"], want["nodes"]):
        assert {n: x[0] for n, x in g.items()} \
            == {n: x[0] for n, x in w.items()}
    assert got["plan"]["model"] == want["model"]
    assert torch_dist.restored_results(lambda: JoinServer(batch_slots=4),
                                       got["snapshot"], card) == got["next"]
    loaded = torch_dist.loaded_server(lambda: JoinServer(batch_slots=4),
                                      SLICE_PAIRS, 256, card)
    assert torch_dist.next_results(loaded) == got["next"]


@pytest.mark.parametrize("world,backend", MESH_WORLDS[1:])
def test_mesh_drill_on_card(card, tmp_path, world, backend):
    """The streaming drill on mesh servers on the card: one failover,
    nothing shed, every window equal to the uninterrupted run."""
    got = _slice_run(card, tmp_path, world, backend)["drill"]
    assert got["failovers"] == 1 and got["shed"] == 0
    assert got["out"] == got["baseline"] and len(got["out"]) == 3
    assert got["dead_stopped"]


# --- the model stack (forward and decode; no kernel of the port) -----------

FAMILY_ARCHS = {"dense": "qwen3-1.7b", "moe": "qwen2-moe-a2.7b",
                "ssm": "falcon-mamba-7b", "hybrid": "recurrentgemma-2b",
                "audio": "whisper-small", "vlm": "phi-3-vision-4.2b"}


def _model_batch(cfg, B=2, T=16, seed=0):
    from repro_torch.models.model import CLIP_DIM
    g = torch.Generator().manual_seed(seed)
    b = {"tokens": torch.randint(0, cfg.vocab, (B, T), generator=g)}
    if cfg.num_img_tokens:
        b["img_embeds"] = torch.randn((B, cfg.num_img_tokens, CLIP_DIM),
                                      generator=g)
    if cfg.is_encdec:
        e = cfg.encoder
        b["frames"] = torch.randn((B, e.n_frames, e.d_input), generator=g)
    return b


def _forward_and_decode(model, b, steps):
    logits, _ = model.forward(b)
    cache = model.init_cache(b["tokens"].shape[0], steps, b.get("frames"))
    dec = []
    for t in range(steps):
        step, cache = model.decode_step(b["tokens"][:, t], cache)
        dec.append(step)
    return logits.cpu().double(), torch.stack(dec, 1).cpu().double()


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_reduced_model_on_card_matches_cpu(card, family, monkeypatch):
    """One ``reduced()`` config of each family, the same weights carried
    to the card through the JAX package's pytree layout: forward and 16
    decode steps against the CPU's, in float32 within 1e-4 of the logits'
    scale (1e-3 for the scans) and, but for the MoE (whose top-k choice a
    bf16 rounding step can flip), in bf16 within a mean of 2e-2 and a
    largest difference of 0.08 (tests/torch_models_parity.py)."""
    from repro_torch.models import ARCHS, Model
    from repro_torch.models import layers, moe, rglru, ssm
    from repro_torch.models.convert import params_from_jax, params_to_jax
    cfg = ARCHS[FAMILY_ARCHS[family]].reduced()
    cpu = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    gpu = params_from_jax(cfg, params_to_jax(cpu), device=card)
    assert gpu.device.type == torch.device(card).type
    b = _model_batch(cfg)
    for dtype in (torch.float32, torch.bfloat16):
        if dtype == torch.bfloat16 and cfg.moe:
            continue
        with monkeypatch.context() as m:
            for mod in (layers, moe, ssm, rglru):
                m.setattr(mod, "COMPUTE_DTYPE", dtype)
            m.setattr(layers.init_kv_cache, "__defaults__", (dtype, "cuda"))
            want = _forward_and_decode(cpu, b, 16)
            got = _forward_and_decode(
                gpu, {k: v.to(card) for k, v in b.items()}, 16)
        for w, g in zip(want, got):
            d = (g - w).abs() / w.abs().max()
            if dtype == torch.float32:
                assert float(d.max()) <= (1e-3 if family in ("ssm", "hybrid")
                                          else 1e-4)
            else:
                assert float(d.max()) <= 0.08 and float(d.mean()) <= 2e-2


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_decode_matches_forward_on_card(card, family):
    """At the default bf16, every one of 24 decode steps from an empty cache
    within the reference's 0.08 of the teacher-forced forward's logits at
    that position (a VLM decodes without its image prefix, so against the
    text-only forward of the same weights)."""
    import dataclasses

    from repro_torch.models import ARCHS, Model
    cfg = ARCHS[FAMILY_ARCHS[family]].reduced()
    model = Model(cfg, device=card)
    b = {k: v.to(card) for k, v in _model_batch(cfg, T=24).items()}
    model.cfg = dataclasses.replace(cfg, num_img_tokens=0)
    want, _ = model.forward(b)
    model.cfg = cfg
    cache = model.init_cache(2, 24, b.get("frames"))
    for t in range(24):
        got, cache = model.decode_step(b["tokens"][:, t], cache)
        w = want[:, t]
        assert float((got - w).abs().max() / w.abs().max()) < 0.08, t


# --- training (no kernel of the port) --------------------------------------

def _grads_and_loss(model, b):
    for p in model.parameters():
        p.grad = None
    loss, _ = model.loss(b)
    loss.backward()
    return float(loss.detach()), {k: p.grad.double().cpu()
                                  for k, p in model.named_parameters()}


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_train_step_on_card_matches_cpu(card, family, monkeypatch):
    """One ``reduced()`` config of each family, the same weights on the
    card and the CPU, in float32 compute: the loss within rtol 1e-5 and
    every grad within 1e-4 of its leaf's largest (1e-3 for the scans); then
    a train step's loss and grad norm within rtol 1e-5 and 1e-4.  (Its
    params are not compared: AdamW moves an element by about lr whatever
    its grad's size, so a grad within rounding of 0 steps either way.)"""
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.models import ARCHS, Model
    from repro_torch.models import layers, moe, rglru, ssm
    from repro_torch.models.convert import params_from_jax, params_to_jax
    from repro_torch.runtime.train import make_train_step, train_state_init
    cfg = ARCHS[FAMILY_ARCHS[family]].reduced()
    cpu = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    gpu = params_from_jax(cfg, params_to_jax(cpu), device=card)
    b = _model_batch(cfg)
    b.update(lm_batch(0, 0, batch=2, seq=16, vocab=cfg.vocab,
                      structured=True, device="cpu"))
    bg = {k: v.to(card) for k, v in b.items()}
    tol = 1e-3 if family in ("ssm", "hybrid") else 1e-4
    with monkeypatch.context() as m:
        for mod in (layers, moe, ssm, rglru):
            m.setattr(mod, "COMPUTE_DTYPE", torch.float32)
        lc, gc = _grads_and_loss(cpu, b)
        lg, gg = _grads_and_loss(gpu, bg)
        assert abs(lg - lc) <= 1e-5 * abs(lc)
        for k, w in gc.items():
            scale = float(w.abs().max()) or 1.0
            assert float((gg[k] - w).abs().max()) <= tol * scale, k
        mets = [make_train_step(model, total_steps=10, warmup=2)(
            train_state_init(model), batch)[1]
            for model, batch in ((cpu, b), (gpu, bg))]
    want, got = ({k: float(v) for k, v in x.items()} for x in mets)
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert abs(got["grad_norm"] - want["grad_norm"]) <= \
        1e-4 * want["grad_norm"]


def test_nccl_dp_on_two_cards_matches_one(card, tmp_path):
    """Plain DP over NCCL, a card a rank, against one card on the whole
    batch in float32 compute: losses and params within rtol 5e-3, atol
    5e-4 (``tests/test_torch_train_distributed.py``)."""
    import torch_dist
    from torch_train_ranks import train_span

    from repro_torch.models import ARCHS
    _mesh_cards(2, "nccl")
    cfg = ARCHS["qwen2-0.5b"].reduced(vocab=128)
    ranks = torch_dist.spawn(train_span, 2,
                             (cfg, 0, 4, 4, 8, 32, False, None, True),
                             tmp_path, device="cuda", backend="nccl")
    one = train_span(None, card, cfg, 0, 4, 4, 8, 32, float32=True)
    for k, v in one["params"].items():
        np.testing.assert_allclose(ranks[0]["params"][k], v, rtol=5e-3,
                                   atol=5e-4, err_msg=k)
        np.testing.assert_array_equal(ranks[1]["params"][k],
                                      ranks[0]["params"][k])
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=5e-3,
                               atol=5e-4)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_nccl_tp_on_cards_matches_one(card, tmp_path, shape):
    """Tensor and expert parallelism over NCCL, a card a rank, on a
    (data, model) mesh of ``shape``: a reduced qwen2-moe (block-EP, a
    vocab-parallel table) trained 3 steps against one card on the whole
    batch in float32 compute: losses and the gathered params within rtol
    5e-3, atol 5e-4, the overflow equal."""
    import torch_dist
    from torch_train_ranks import train_span

    from repro_torch.models import ARCHS
    world = shape[0] * shape[1]
    _mesh_cards(world, "nccl")
    cfg = ARCHS["qwen2-moe-a2.7b"].reduced(vocab=128)
    ranks = torch_dist.spawn(train_span, world,
                             (cfg, 0, 3, 3, 8, 32, False, None, True),
                             tmp_path, mesh_shape=shape, device="cuda",
                             backend="nccl")
    one = train_span(None, card, cfg, 0, 3, 3, 8, 32, float32=True)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=5e-3,
                                   atol=5e-4)
        assert r["overflow"] == one["overflow"]
        for k, v in one["params"].items():
            np.testing.assert_allclose(r["params"][k], v, rtol=5e-3,
                                       atol=5e-4, err_msg=k)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b",
                                  "whisper-small"])
def test_nccl_tp_scans_on_cards_match_one(card, tmp_path, arch, shape):
    """The Mamba mixer over ``d_inner``, the RG-LRU mixer over ``lru`` (80
    channels in blocks of 16: a rank's straddle them, so its gates
    all_gather) and whisper over NCCL, a card a rank, at tp ``shape[1]``:
    3 train steps of a reduced config against one card on the whole batch
    in float32 compute, losses and the gathered params within rtol 5e-3,
    atol 5e-4."""
    import torch_dist
    from torch_train_ranks import train_span

    from repro_torch.models import ARCHS
    from repro_torch.models.config import RGLRUCfg
    _mesh_cards(shape[1], "nccl")
    kw = {"rglru": RGLRUCfg(lru_width=80, block_width=16)} \
        if arch == "recurrentgemma-2b" else {}
    cfg = ARCHS[arch].reduced(vocab=128, **kw)
    ranks = torch_dist.spawn(train_span, shape[1],
                             (cfg, 0, 3, 3, 8, 32, False, None, True),
                             tmp_path, mesh_shape=shape, device="cuda",
                             backend="nccl")
    one = train_span(None, card, cfg, 0, 3, 3, 8, 32, float32=True)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=5e-3,
                                   atol=5e-4)
        for k, v in one["params"].items():
            np.testing.assert_allclose(r["params"][k], v, rtol=5e-3,
                                       atol=5e-4, err_msg=k)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_nccl_sharded_decode_on_cards_matches_one(card, tmp_path, shape):
    """Decode of a sharded model over NCCL, a card a rank, on a
    ``kv_seq``-sharded cache: five reduced configs (Mamba, RG-LRU with a
    local attention, whisper, GQA, a local ring buffer with softcaps)
    decode 8 steps from a 20-token prefix cut by ``shard_cache``, in
    float32 compute, against one card: the logits within 1e-4 of the scale
    (1e-3 on a scan), the gathered cache the one card's within the same
    bound of each leaf's scale."""
    import torch_dist
    from torch_train_ranks import compute_dtype, tp_decode_rank

    from repro_torch.models import ARCHS, Model
    from repro_torch.models.convert import params_to_jax
    from repro_torch.sharding.axes import cache_leaves
    _mesh_cards(shape[0] * shape[1], "nccl")
    B, prefix, steps, max_seq = 4, 20, 8, 32
    cases, want = [], []
    for arch, kw in (("falcon-mamba-7b", {}), ("recurrentgemma-2b", {}),
                     ("whisper-small", {}), ("qwen3-1.7b", {}),
                     ("gemma2-9b", {"window": 16})):
        cfg = ARCHS[arch].reduced(**kw)
        b = _model_batch(cfg, B=B, T=prefix + steps)
        with compute_dtype(torch.float32), torch.no_grad():
            model = Model(cfg, device=card)
            frames = b.get("frames")
            cache = model.init_cache(B, max_seq, None if frames is None
                                     else frames.to(card))
            logits = []
            for t in range(prefix + steps):
                if t == prefix:
                    at_prefix = {k: v.cpu().numpy().copy() for k, v in
                                 cache_leaves(cache).items()}
                lt, cache = model.decode_step(b["tokens"][:, t].to(card),
                                              cache)
                logits.append(lt.cpu().numpy())
        tokens = b["tokens"].numpy()[:, prefix:]
        cases.append((cfg, params_to_jax(model), tokens,
                      None if frames is None else frames.numpy(), max_seq,
                      at_prefix))
        want.append((np.stack(logits[prefix:], 1),
                     {k: v.float().cpu().numpy()
                      for k, v in cache_leaves(cache).items()}))
    ranks = torch_dist.spawn(tp_decode_rank, shape[0] * shape[1], (cases,),
                             tmp_path, mesh_shape=shape, device="cuda",
                             backend="nccl")
    for (cfg, *_), (logits, final), *got in zip(cases, want, *ranks):
        tol = 1e-3 if cfg.family in ("ssm", "hybrid") else 1e-4
        for g in got:
            w = logits[slice(*g["rows"])]
            assert np.abs(g["logits"] - w).max() <= tol * np.abs(w).max(), \
                cfg.name
            for k, v in final.items():
                scale = float(np.abs(v).max()) or 1.0
                assert np.abs(g["cache"][k] - v).max() <= tol * scale, \
                    (cfg.name, k)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_nccl_seq_parallel_on_cards_matches_one(card, tmp_path, shape):
    """Sequence parallelism (``qwen2-0.5b``'s ``seq`` rule bound) over NCCL,
    a card a rank, on a (data, model) mesh of ``shape``: 3 train steps of
    a reduced config against one card on the whole batch in float32
    compute, losses and the gathered params within rtol 5e-3, atol
    5e-4."""
    import torch_dist
    from torch_train_ranks import train_span

    from repro_torch.models import ARCHS
    world = shape[0] * shape[1]
    _mesh_cards(world, "nccl")
    cfg = ARCHS["qwen2-0.5b"].reduced(vocab=128)
    ranks = torch_dist.spawn(train_span, world,
                             (cfg, 0, 3, 3, 8, 32, False, None, True,
                              {"seq": "model"}),
                             tmp_path, mesh_shape=shape, device="cuda",
                             backend="nccl")
    one = train_span(None, card, cfg, 0, 3, 3, 8, 32, float32=True)
    for r in ranks:
        assert any(k.startswith("reduce_scatter") for k in r["comm"])
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=5e-3,
                                   atol=5e-4)
        for k, v in one["params"].items():
            np.testing.assert_allclose(r["params"][k], v, rtol=5e-3,
                                       atol=5e-4, err_msg=k)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_zero1_dp_on_the_card_matches_plain_dp(card, tmp_path, backend):
    """ZeRO-1 at (data, model) = (2, 1), gloo ranks sharing the card or
    NCCL a card a rank: 3 train steps of a reduced ``qwen2-0.5b`` in
    float32 compute against plain DP on the same ranks (losses, ``m`` and
    ``v`` within rtol 1e-5, atol 1e-5 of the leaf's scale; params within
    rtol 1e-5, atol 1e-6: ``tests/test_torch_zero1.py``) and against one
    card on the whole batch (rtol 5e-3, atol 5e-4); a rank's slots are the
    whole moments cut by ``slot_specs``."""
    import torch_dist
    from torch_train_ranks import train_span

    from repro_torch.models import ARCHS
    _mesh_cards(2, backend)
    cfg = ARCHS["qwen2-0.5b"].reduced(vocab=128)
    runs = {z: torch_dist.spawn(train_span, 2,
                                (cfg, 0, 3, 3, 8, 32, False, None, True,
                                 None, z), tmp_path, device="cuda",
                                backend=backend)
            for z in (False, True)}
    one = train_span(None, card, cfg, 0, 3, 3, 8, 32, float32=True)
    plain, zero1 = runs[False][0], runs[True][0]
    assert all(r["slot_err"] == 0.0 for r in runs[True])
    assert zero1["slot_bytes"] < plain["slot_bytes"]
    np.testing.assert_allclose(zero1["losses"], plain["losses"], rtol=1e-5)
    for field in ("params", "m", "v"):
        for k, w in plain[field].items():
            np.testing.assert_allclose(
                zero1[field][k], w, rtol=1e-5, err_msg=f"{field} {k}",
                atol=1e-6 if field == "params" else 1e-5 * np.abs(w).max())
    for k, w in one["params"].items():
        np.testing.assert_allclose(zero1["params"][k], w, rtol=5e-3,
                                   atol=5e-4, err_msg=k)


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_dry_run_meters_hold_against_the_card(card, shape):
    """Phase 16 (c) at a smaller depth: ``qwen3-1.7b`` at full width cut to
    one layer, [2, 1024], mesh 1, dry-run on ``meta`` and run on the card:
    the counted flops equal, the ``meta`` peak within 0.75-1.33 x the card
    allocator's growth, the roofline floor at most the measured time."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import fake_ranks, make_host_mesh
    kw = dict(cfg_overrides={"n_layers": 1}, batch=2, seq=1024,
              verbose=False)
    with fake_ranks(1):
        mesh = make_host_mesh(1, 1)
        meta = DR.run_cell("qwen3-1.7b", shape, mesh, **kw)
        real = DR.run_cell("qwen3-1.7b", shape, mesh, device=card, **kw)
    for rec in (meta, real):
        assert rec["status"] == "ok", rec.get("traceback")
    fm, fr = (r["roofline"] for r in (meta, real))
    assert fm["flops_per_device"] == fr["flops_per_device"] > 0
    share = meta["memory"]["temp_bytes"] / real["memory"]["temp_bytes"]
    assert 0.75 <= share <= 1.33, share
    assert max(fr["compute_s"], fr["memory_s"]) <= real["measured_s"]
