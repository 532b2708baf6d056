"""The port's mesh JoinServer on gloo ranks against its meshless server.

Rank 0 serves (``JoinServer(mesh=...)``) and the other ranks run
``serve_mesh_worker`` (``torch_dist.serve_rank``), one spawn a mesh size
(1, 2 and 4 ranks), every case of that size in it.  The same script runs
on a meshless server in this process, and the mesh server must equal it
bit for bit in exact-parity (results, sigma tables, strata keys, live
counts) and on the kernel route, and within rtol 1e-5 under psum.  The
reference's own mesh server is no oracle: its parity test fails (ROADMAP
§C); the meshless server is held to the JAX package by
``test_torch_join_serve.py``.  Also ported from the reference's
``tests/test_join_serve_distributed.py``: serve_mode cache isolation, the
meshless server normalising serve_mode, a forced bucket overflow that is
counted, and shape classes that key on the mesh shape; and the memory
share an async front door divides among the replicas on its card.
"""

import sys

import numpy as np
import pytest
import torch

import repro.core.relation  # noqa: F401  (repro.core re-exports a function so named)
from repro.runtime import join_serve as jserve
from repro_torch.core.budget import QueryBudget
from repro_torch.core.relation import relation
from repro_torch.runtime import join_serve
from repro_torch.runtime.async_serve import AsyncJoinFrontDoor
from repro_torch.runtime.join_serve import (SLOT_MEMORY_SHARE, JoinRequest,
                                            JoinServer, ShapeClass,
                                            bloom_overlap_estimate,
                                            shape_class_of, slot_bytes)
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_dist import routed_bytes, run_script, serve_rank, spawn

jrel = sys.modules["repro.core.relation"]

MS, BM = 1024, 512
RTOL = 1e-5


def _data(seed=0, n=1 << 12):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 500, n).astype(np.uint32),
             rng.normal(10, 2, n).astype(np.float32), np.ones(n, bool)),
            (rng.integers(400, 900, n).astype(np.uint32),
             rng.normal(5, 1, n).astype(np.float32), np.ones(n, bool))]


DATA = _data()


def _q(qid, seed, budget=(None, 0.5), **kw):
    return {"query_id": qid, "seed": seed, "budget": budget,
            "max_strata": MS, "b_max": BM, **kw}


# (server kwargs, [requests of each run()]); every script runs on every
# mesh size and on the meshless server
SCRIPT = {
    # pilot rounds, an exact request and a sigma round, then a kernel
    # request, then the same under psum
    "parity": ({"batch_slots": 2}, [
        [_q("tA", 5), _q("tB", 6), _q("tC", 7, ()), _q("tA", 8)],
        [_q("k0", 21, use_kernels=True)],
        [_q("pA", 5, serve_mode="psum"), _q("pC", 7, (), serve_mode="psum"),
         _q("pA", 8, serve_mode="psum")]]),
    # warm every stage, then no new builds and no new filters
    "cache": ({"batch_slots": 2}, [
        [_q(f"w{i}", 11) for i in range(2)]
        + [_q(f"we{i}", 11, ()) for i in range(2)],
        [_q(f"m{i}", 11) for i in range(4)]
        + [_q(f"me{i}", 11, ()) for i in range(4)]]),
    # two kernel requests of one dataset in one step: its rows gather once
    "memo": ({"batch_slots": 2, "step_once": True}, [
        [_q("k0", 21, use_kernels=True, filter_seed=21),
         _q("k1", 22, use_kernels=True, filter_seed=21)]]),
    # serve_mode keys its own stages: switching compiles once, then hits
    "modes": ({"batch_slots": 2}, [
        [_q(mode, seed, serve_mode=mode)]
        for seed in (7, 8) for mode in ("exact-parity", "psum")]),
    # an under-provisioned bucket plan counts what it drops
    "tight": ({"batch_slots": 1, "serve_mode": "psum", "bucket_cap": 64},
              [[_q("t", 3, (), max_strata=2048)]]),
    "lossless": ({"batch_slots": 1, "serve_mode": "psum"},
                 [[_q("t", 3, (), max_strata=2048)]]),
}


@pytest.fixture(scope="module")
def meshless():
    rels = [relation(k, v, m, device="cpu") for k, v, m in DATA]
    return dict(zip(SCRIPT, run_script(JoinServer, rels,
                                       list(SCRIPT.values()))))


_SPAWNED: dict = {}


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """Rank 0's results of every script on a mesh of ``k`` ranks."""
    def get(k):
        if k not in _SPAWNED:
            got = spawn(serve_rank, k, (DATA, list(SCRIPT.values())),
                        tmp_path_factory.mktemp("serve"))
            _SPAWNED[k] = dict(zip(SCRIPT, got[0]))
            # every worker ran each server's operations to its shutdown
            assert all(len(ops) == len(SCRIPT) and min(ops) > 0
                       for ops in got[1:])
        return _SPAWNED[k]
    return get


def _close(got, want):
    return all(abs(g - w) <= RTOL * max(abs(w), 1e-30)
               for g, w in zip(got, want))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_mesh_server_bit_identical_to_meshless(k, mesh, meshless):
    got, want = mesh(k)["parity"], meshless["parity"]
    for g, w in zip(got["results"][:5], want["results"][:5]):
        assert g[:5] == w[:5]                      # surface and drops
        np.testing.assert_array_equal(g[5], w[5])  # strata keys
        np.testing.assert_array_equal(g[6], w[6])  # live counts
    assert got["sigma"] == want["sigma"]
    snap = got["snaps"][0]
    assert len(snap["per_device_shuffled_bytes"]) == k
    assert sum(snap["per_device_shuffled_bytes"]) \
        == snap["dist_shuffled_tuple_bytes"]
    if k > 1:
        assert all(b > 0 for b in snap["per_device_shuffled_bytes"])
        assert 0 < snap["dist_shuffled_tuple_bytes"] \
            <= snap["dist_wire_bytes_model"]
    else:
        assert snap["dist_shuffled_tuple_bytes"] == 0


@pytest.mark.parametrize("k", [1, 2, 4])
def test_mesh_server_shuffled_bytes_equal_what_the_data_routes(k, mesh):
    """Each serving pass's shuffle bytes by rank are, request by request,
    the live rows of the rank's block whose keys route elsewhere (a
    request's filter seed is its seed here); the kernel request shuffles
    nothing."""
    snaps = [np.zeros(k)] + [np.asarray(s["per_device_shuffled_bytes"])
                             for s in mesh(k)["parity"]["snaps"]]
    for run, seeds in enumerate(((5, 6, 7, 8), (), (5, 7, 8))):
        want = sum((routed_bytes(DATA, k, s) for s in seeds), np.zeros(k))
        np.testing.assert_array_equal(snaps[run + 1] - snaps[run], want)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_mesh_server_psum_within_rtol(k, mesh, meshless):
    got, want = mesh(k)["parity"], meshless["parity"]
    for g, w in zip(got["results"][5:], want["results"][5:]):
        assert _close(g[:4], w[:4]), (g[:4], w[:4])
        assert g[4] == 0.0                          # nothing dropped
    # the class keys the merge and the mesh shape
    cls = ShapeClass(*got["classes"][5])
    assert cls.serve_mode == "psum" and cls.mesh == (("data", k),
                                                     ("model", 1))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_kernel_class_gathers_rows_to_rank0(k, mesh, meshless):
    got, want = mesh(k), meshless
    assert got["parity"]["results"][4][:4] == want["parity"]["results"][4][:4]
    one = got["parity"]["snaps"][1]["kernel_gather_bytes"] \
        - got["parity"]["snaps"][0]["kernel_gather_bytes"]
    assert ShapeClass(*got["parity"]["classes"][4]).mesh == ()
    if k == 1:
        assert one == 0
    else:
        # a row crosses as 12 bytes; rank 0 receives the other ranks' rows
        assert one == 2 * 12 * (1 << 12) * (k - 1) // k
    # two slots of one dataset: its rows move once
    memo = got["memo"]
    assert memo["snaps"][0]["steps"] == 1
    assert memo["snaps"][0]["kernel_gather_bytes"] == one
    assert [r[:4] for r in memo["results"]] \
        == [r[:4] for r in want["memo"]["results"]]


@pytest.mark.parametrize("k", [1, 2, 4])
def test_mesh_stages_warm_then_reused(k, mesh, meshless):
    warm, after = mesh(k)["cache"]["snaps"]
    assert warm["compiles"] >= 4
    assert after["compiles"] == warm["compiles"]
    assert after["cache_hits"] > warm["cache_hits"]
    # dataset filters were built once a relation for seed 11 and reused
    assert after["filter_builds"] == warm["filter_builds"] == 2
    assert after["filter_cache_hits"] > warm["filter_cache_hits"]
    if k > 1:   # the OR-reduce puts k - 1 copies of the words on the wire
        assert warm["filter_exchange_bytes_measured"] > 0
    assert [r[:4] for r in mesh(k)["cache"]["results"]] \
        == [r[:4] for r in meshless["cache"]["results"]]


@pytest.mark.parametrize("k", [1, 2])
def test_forced_bucket_overflow_is_counted(k, mesh):
    tight, free = mesh(k)["tight"], mesh(k)["lossless"]
    d = tight["snaps"][0]
    assert d["dist_dropped_tuples"] > 0
    assert sum(d["per_device_dropped_tuples"]) == d["dist_dropped_tuples"]
    assert tight["results"][0][4] == d["dist_dropped_tuples"]
    assert free["snaps"][0]["dist_dropped_tuples"] == 0
    assert free["results"][0][4] == 0.0
    assert tight["results"][0][2] < free["results"][0][2]    # count


def test_serve_mode_cache_isolation(mesh):
    """psum and exact-parity stages never share a cache entry: switching
    modes builds once, then each mode hits its own; at mesh 1 both merges
    run the same arithmetic."""
    got = mesh(1)["modes"]
    c_parity, c_both = (s["compiles"] for s in got["snaps"][:2])
    assert c_both > c_parity
    assert got["snaps"][-1]["compiles"] == c_both
    assert got["snaps"][-1]["cache_hits"] > 0
    par, psum = (ShapeClass(*c) for c in got["classes"][:2])
    assert par != psum
    assert par._replace(serve_mode="psum", bucket_cap=psum.bucket_cap) \
        == psum                                   # the ONLY key difference
    assert got["results"][1][:2] == got["results"][0][:2]


def test_meshless_server_normalizes_serve_mode():
    """Off the mesh there is one pipeline (the exact one): psum requests
    fold into the exact-parity class instead of forking the cache."""
    rels = [relation(k, v, m, device="cpu") for k, v, m in DATA]
    srv = JoinServer(batch_slots=2)
    q = srv.submit(JoinRequest(rels=rels, budget=QueryBudget(error=0.5),
                               query_id="t", seed=1, max_strata=256,
                               b_max=128, serve_mode="psum"))
    assert q._class.serve_mode == "exact-parity"
    assert q._class.bucket_cap == 0
    with pytest.raises(ValueError):
        srv.submit(JoinRequest(rels=rels, budget=QueryBudget(), query_id="t",
                               max_strata=256, b_max=128,
                               serve_mode="gossip"))


def test_shape_class_keys_on_mesh_shape():
    """The same query on different mesh shapes lands in different classes,
    as the reference keys them."""
    rels = [relation(k, v, m, device="cpu") for k, v, m in DATA]
    req = JoinRequest(rels=rels, budget=QueryBudget(error=0.5),
                      max_strata=512, b_max=128)
    single = shape_class_of(req)
    mesh8 = shape_class_of(req, (("data", 8),))
    mesh2x4 = shape_class_of(req, (("pod", 2), ("data", 4)))
    assert single.mesh == ()
    assert len({single, mesh8, mesh2x4}) == 3
    assert single._replace(mesh=(("data", 8),)) == mesh8
    jreq = jserve.JoinRequest(rels=[jrel.relation(k, v, m)
                                    for k, v, m in DATA],
                              budget=jserve.QueryBudget(error=0.5),
                              max_strata=512, b_max=128)
    assert tuple(jserve.shape_class_of(jreq, (("data", 8),), "psum", 64)) \
        == tuple(shape_class_of(req, (("data", 8),), "psum", 64))


def test_bloom_overlap_estimate_equals_reference():
    rels = [relation(k, v, m, device="cpu") for k, v, m in DATA]
    jrels = [jrel.relation(k, v, m) for k, v, m in DATA]
    for fp, seed in ((0.01, 0), (0.2, 5)):
        assert bloom_overlap_estimate(rels, fp, seed) \
            == jserve.bloom_overlap_estimate(jrels, fp, seed)


def test_front_door_replicas_split_the_memory_share(monkeypatch):
    """Two replicas on one card plan, together, at most the one share a
    lone engine plans for."""
    card = 64 << 30
    monkeypatch.setattr(join_serve, "_card_memory", lambda index: card)
    cls = ShapeClass((1 << 26, 1 << 26), 2, 1 << 16, 2048, "sum", "sum",
                     False, True, 0.01, 0.95)
    dev = torch.device("cuda", 0)
    share = SLOT_MEMORY_SHARE * card
    alone = JoinServer(batch_slots=64)._slot_cap(cls, dev)
    assert 2 * alone * slot_bytes(cls) > share   # each alone: half the card
    fd = AsyncJoinFrontDoor(replicas=2, batch_slots=64, device="cpu")
    try:
        caps = [r.engine._slot_cap(cls, dev) for r in fd.replicas]
    finally:
        fd.close(timeout=60)
    assert all(c >= 1 for c in caps)
    assert sum(caps) * slot_bytes(cls) <= share
