"""The prepare tail's sort, on the CPU: ``sort_by_key`` partitions the rows
by validity and sorts the live ones alone on 32-bit keys, and still gives
the permutation of a stable int64 argsort of the masked keys, bit for bit,
and the JAX package's ``sort_by_key``.  The slot-batched kernel prepare
(pad slots, a side with no live row) equals the single-slot prepare slot by
slot, and a traced served step's ``prepare`` span counts the rows entering
the tail and the rows sorted, whose ratio ``tools/host_split.py`` prints."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.relation  # noqa: F401  (repro.core re-exports a function so named)
from repro_torch.core import join as tjoin
from repro_torch.core.bloom import num_blocks_for
from repro_torch.core.budget import QueryBudget
from repro_torch.core.relation import Relation, relation, sort_by_key
from repro_torch.runtime.join_serve import JoinRequest, JoinServer
from repro_torch.runtime.telemetry import Tracer, span_tree
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

jrel = sys.modules["repro.core.relation"]

EDGES = np.array([0, 2**31 - 1, 2**31, 2**32 - 2], np.uint32)
ANY = np.append(EDGES, np.uint32(2**32 - 1))   # a dead row's key may be any

# name: (rows, live keys, share of live rows)
CASES = {"halves": (1000, "edges", 0.6), "duplicates": (1000, "few", 0.6),
         "mixed": (1000, "wide", 0.6), "all-live": (1000, "edges", 1.0),
         "none-live": (1000, "edges", 0.0), "one-live": (1, "edges", 1.0),
         "one-dead": (1, "edges", 0.0)}


def _case(i, name):
    """(uint32 keys, float32 values, bool valid) of one named case: live
    keys on both sides of 2^31, or from 5 values, or from the whole range
    below 2^32 - 1; dead rows hold keys of every kind."""
    n, kind, share = CASES[name]
    rng = np.random.default_rng(i)
    live = {"edges": rng.choice(EDGES, n),
            "few": rng.integers(0, 5, n),
            "wide": rng.integers(0, 2**32 - 1, n)}[kind]
    valid = rng.random(n) < share
    keys = np.where(valid, live, rng.choice(ANY, n)).astype(np.uint32)
    return keys, rng.normal(0, 1, n).astype(np.float32), valid


@pytest.mark.parametrize("given", [True, False], ids=["count", "no-count"])
@pytest.mark.parametrize("name", list(CASES))
def test_sort_by_key_is_the_int64_argsort(name, given):
    k, v, m = _case(list(CASES).index(name), name)
    rel = relation(k, v, m, device="cpu")
    got = sort_by_key(rel, int(m.sum()) if given else None)
    order = torch.argsort(rel.masked_keys(), stable=True)
    want = Relation(rel.keys[order], rel.values[order], rel.valid[order])
    assert got.keys.dtype == torch.int64 and got.values.dtype == torch.float32
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    ref = jrel.sort_by_key(jrel.relation(k, v, m))
    np.testing.assert_array_equal(got.keys.numpy().astype(np.uint32),
                                  np.asarray(ref.keys))
    np.testing.assert_array_equal(got.values.numpy().view(np.uint32),
                                  np.asarray(ref.values).view(np.uint32))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))


def _side(rng, n, lo, hi):
    return relation(rng.integers(lo, hi, n).astype(np.uint32),
                    rng.normal(5, 2, n).astype(np.float32),
                    rng.random(n) < 0.8, device="cpu")


def test_batched_prepare_with_pad_slots_and_an_empty_side():
    """Four slots, two real: slot 1's first side has no live row (its words
    come from rows that hold some), and slots 2-3 repeat slot 1's inputs.
    Every slot's sorted relations, strata and live counts equal the
    single-slot kernel prepare of the slot it holds."""
    from repro_torch.kernels import ops as kops
    rng = np.random.default_rng(33)
    n, S, nb, B, n_real = 2048, 256, num_blocks_for(2048, 0.01), 4, 2
    seeds = [7, 2**32 - 5]
    slots = [[_side(rng, n, 0, 300), _side(rng, n, 200, 500)]
             for _ in range(n_real)]
    words = torch.stack([torch.stack([kops.build_filter(r.keys, r.valid, nb,
                                                        seeds[b]).words
                                      for r in slots[b]])
                         for b in range(n_real)])
    first = slots[1][0]
    slots[1][0] = first._replace(valid=torch.zeros_like(first.valid))
    held = [min(b, n_real - 1) for b in range(B)]
    rels = [Relation(*(torch.stack([slots[h][i][f] for h in held])
                       for f in range(3))) for i in range(2)]
    prep = tjoin.prepare_stage_kernels_batched(
        rels, words[held], S, torch.tensor([seeds[h] for h in held]),
        n_real=n_real)
    for b, h in enumerate(held):
        one = tjoin.prepare_stage_kernels(slots[h], nb, S, seeds[h],
                                          filter_words=words[h])
        for x, y in zip(tjoin._slot(prep.sorted_rels, b), one.sorted_rels):
            for u, w in zip(x, y):
                assert torch.equal(u, w)
        for x, y in zip(tjoin._slot(prep.strata, b), one.strata):
            assert torch.equal(x, y)
        assert torch.equal(prep.live_counts[b], one.live_counts)
        assert torch.equal(prep.sorted_rows[b], one.live_counts)
    assert prep.live_counts[1, 0] == 0 and prep.live_counts[1, 1] > 0


def _pair(seed, n=512):
    r = np.random.default_rng(seed)
    return [relation(r.integers(0, 200, n).astype(np.uint32),
                     r.normal(10, 2, n).astype(np.float32),
                     r.random(n) < 0.9, device="cpu"),
            relation(r.integers(150, 350, n).astype(np.uint32),
                     r.normal(5, 1, n).astype(np.float32), device="cpu")]


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel"])
def test_traced_prepare_span_counts_rows_and_sorted(use_kernels):
    """Three requests over four slots (one pad slot): the step's ``prepare``
    span carries ``rows``, the real slots' capacity rows, and ``sorted``, the
    sum of their live counts."""
    tr = Tracer(enabled=True)
    srv = JoinServer(batch_slots=4, tracer=tr)
    reqs = [srv.submit(JoinRequest(
        rels=_pair(s), budget=QueryBudget(error=0.5) if s % 2 else
        QueryBudget(), query_id=f"q{s}", seed=s, max_strata=256, b_max=128,
        use_kernels=use_kernels)) for s in (1, 2, 3)]
    assert srv.step() == 3
    step = [n for n in span_tree(e for e in tr.events if e["tid"] == "engine")
            if n["name"] == "step"][0]
    spans = [c for c in step["children"] if c["name"] == "prepare"]
    assert len(spans) == 1
    live = sum(int(r.result.diagnostics.live_counts.sum()) for r in reqs)
    assert 0 < live < 3 * 2 * 512
    assert spans[0]["args"]["rows"] == 3 * 2 * 512
    assert spans[0]["args"]["sorted"] == live
    tool = importlib.util.spec_from_file_location(
        "host_split", Path(__file__).parents[1] / "tools" / "host_split.py")
    host_split = importlib.util.module_from_spec(tool)
    tool.loader.exec_module(host_split)
    got = host_split.split(tr.events, span_tree)["sorted_rows_pct"]
    assert got == 100 * live / (3 * 2 * 512)
