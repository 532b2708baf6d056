"""Query plans, snapshots, the async fleet and its fault drill on a mesh of
gloo ranks, against the port's meshless server.

One spawn of 2 ranks (``torch_dist.fleet_rank``) and one of 4 ranks as a
(2, 2) mesh (``torch_dist.layout_rank``) run every case; the meshless
counterparts run in this process.  In exact-parity every plan node equals
the meshless server's bit for bit at k = 2 and 4, the compiled byte model
equals the meshless one exactly, and the plan gate passes in both merges
(the counterparts of the reference's ``test_plan_mesh2_bit_identical_to_
meshless`` and ``test_plan_accuracy_gate_mesh_2_4_8``).  A front door of
two mesh servers over the same ranks equals the sync mesh server
(``test_async_mesh_parity``), two mesh servers serve from two threads at
once, and the streaming drill on mesh servers fails over once, sheds
nothing and matches the uninterrupted run
(``test_kill_and_resume_mesh_parity``).  A mesh server's snapshot is the
meshless server's, array for array, and restores into a meshless server,
into a mesh of another size and into another layout of the same ranks
(a (2, 2) mesh joined over ``data``, each block on two ranks, and over both
axes) with the same next results; on that mesh, over either layout,
stream windows equal the meshless ones bit for bit.
"""

import numpy as np
import pytest

from repro_torch.core.budget import QueryBudget
from repro_torch.core.window import WindowSpec
from repro_torch.data.synthetic import overlapping_relations
from repro_torch.runtime.join_serve import JoinServer
from repro_torch.runtime.stream_join import StreamJoinServer
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_dist import (_from_arrays, fleet_rank, fleet_workload_sync,
                        layout_rank, loaded_server, next_results,
                        restored_results, same_window, serve_plan,
                        snapshot_arrays, spawn, stream_windows)

BM = 256


def _np(rels):
    return [tuple(x.numpy() for x in r) for r in rels]


def _pair(seed, n=1 << 11):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 500, n).astype(np.uint32),
             rng.normal(5 + seed, 2, n).astype(np.float32), np.ones(n, bool)),
            (rng.integers(400, 900, n).astype(np.uint32),
             rng.normal(5, 1, n).astype(np.float32), np.ones(n, bool))]


def _arrays(seed, n=256):
    r = np.random.default_rng(seed)
    return [(r.integers(0, 200, n).astype(np.uint32),
             r.normal(10, 2, n).astype(np.float32)),
            (r.integers(150, 350, n).astype(np.uint32),
             r.normal(5, 1, n).astype(np.float32))]


PAIRS = [_pair(1), _pair(2)]
PLAN_DATA = _np(overlapping_relations([1 << 10] * 4, 0.25, seed=3,
                                      device="cpu"))
BATCHES = [_arrays(100 + t) for t in range(6)]
SUB = 256
# sliding windows on a (2, 2) mesh: plain mesh classes and the kernel route
STREAMS = [dict(name=name, spec=(4, 1, SUB), budget=(None, 0.5),
                mode="exact-parity", kernels=kernels, ms=1024, bm=BM, seed=3,
                batches=BATCHES)
           for name, kernels in (("slide", False), ("kern", True))]


def _meshless():
    return JoinServer(batch_slots=4)


@pytest.fixture(scope="module")
def meshless():
    return dict(plan=serve_plan(_meshless(), PLAN_DATA, BM),
                sync=fleet_workload_sync(_meshless, PAIRS, BM),
                next=next_results(loaded_server(_meshless, PAIRS, BM)),
                snapshot=snapshot_arrays(loaded_server(_meshless, PAIRS,
                                                       BM)),
                streams={c["name"]: stream_windows(
                    StreamJoinServer(batch_slots=2), c, "cpu")
                    for c in STREAMS})


@pytest.fixture(scope="module")
def mesh2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    got = spawn(fleet_rank, 2, (PAIRS, PLAN_DATA, BATCHES,
                                str(tmp / "ckpt"), BM), tmp)
    return dict(got[0], workers=got[1:], k=2)


@pytest.fixture(scope="module")
def mesh4(tmp_path_factory, mesh2):
    got = spawn(layout_rank, 4, (PAIRS, PLAN_DATA, mesh2["snapshot"], BM,
                                 STREAMS),
                tmp_path_factory.mktemp("layout"), mesh_shape=(2, 2))
    return dict(got[0], workers=got[1:], k=4)


@pytest.fixture
def mesh(request, mesh2, mesh4):
    return {2: mesh2, 4: mesh4}[request.param]


K = pytest.mark.parametrize("mesh", [2, 4], indirect=True,
                            ids=["k2", "k4"])


@K
def test_plan_nodes_bit_identical_to_meshless(mesh, meshless):
    """Every node of every submission (plain twice, then the kernel route)
    equals the meshless server's; the byte model equals the meshless one
    exactly; a second submission of a plan compiles nothing; the model read
    the leaves' rows once per plan signature, gathered to rank 0."""
    got, want = mesh["plan"], meshless["plan"]
    assert len(got["nodes"]) == 3
    for g, w in zip(got["nodes"], want["nodes"]):
        assert set(g) == set(w) == {"ab", "abc"}
        for name in g:
            assert g[name][0] == w[name][0], name
            np.testing.assert_array_equal(g[name][1], w[name][1])
    assert got["model"] == want["model"]
    assert (got["compiles"], got["hits"]) == (want["compiles"],
                                              want["hits"]) == (2, 2)
    k = mesh["k"]
    # leaves a, b and c, 12 bytes a row, under 2 plan signatures
    assert got["gathered"] == 2 * 3 * 12 * (1 << 10) * (k - 1) // k


@K
@pytest.mark.parametrize("mode", ["exact-parity", "psum"])
def test_plan_accuracy_gate_on_a_mesh(mesh, mode):
    gate = mesh["plan_gates"][mode]
    assert gate["passed"], gate["summary"]
    assert gate["alloc"]
    if mode == "exact-parity":
        assert gate["dropped"] == 0.0


def test_async_mesh_fleet_equals_sync_mesh_server(mesh2, meshless):
    """Two mesh-server replicas over the same 2 ranks behind a front door
    serve the workload bit for bit as the sync mesh server, which equals
    the meshless server."""
    (surfaces, _steals) = mesh2["async"]
    assert surfaces == mesh2["sync"] == meshless["sync"]


def test_two_mesh_servers_from_two_threads(mesh2, meshless):
    got, alive = mesh2["threads"]
    assert alive == [False, False]               # no hang
    assert got["x"] == got["y"] == meshless["sync"]


def test_kill_and_resume_on_a_mesh(mesh2):
    """The streaming drill on mesh servers: replica0 dies after its first
    window, the successor restores its checkpoint onto the mesh, one
    failover, nothing shed, every window equal to the uninterrupted mesh
    run, which equals the meshless one; the dead server's state is gone
    from the ranks."""
    got = mesh2["drill"]
    assert got["failovers"] == 1 and got["shed"] == 0
    assert sorted(got["out"]) == sorted(got["baseline"]) == [0, 1, 2]
    assert got["out"] == got["baseline"]
    assert got["dead_stopped"]
    base = StreamJoinServer(batch_slots=4)
    sess = base.open_stream("tenA", WindowSpec(2, 2, 256),
                            budget=QueryBudget(error=0.5), max_strata=1024,
                            b_max=BM, seed=7)
    for arr in BATCHES:
        sess.push(_from_arrays(arr, "cpu"))
        base.run()
    meshless = {r.window_id: tuple(float(getattr(r.result, f)) for f in (
        "estimate", "error_bound", "count", "dof")) for r in sess.drain()}
    assert got["baseline"] == meshless


def test_mesh_snapshot_is_the_meshless_snapshot(mesh2, meshless):
    """A mesh server's snapshot gathers every relation in its global row
    order: array for array the meshless server's of the same state, with
    the same queue, filter cache and sigma table."""
    (flat, meta), (wflat, wmeta) = mesh2["snapshot"], meshless["snapshot"]
    assert set(flat) == set(wflat)
    for key in flat:
        np.testing.assert_array_equal(flat[key], wflat[key], err_msg=key)
    for part in ("queue", "filter_cache", "sigma"):
        assert meta[part] == wmeta[part], part
    assert [d["fps"] for d in meta["datasets"]] \
        == [d["fps"] for d in wmeta["datasets"]]
    # the mesh's overlap estimates travel with the checkpoint
    assert all(d["overlap"] is not None for d in meta["datasets"])


def test_mesh_checkpoint_restores_anywhere(mesh2, mesh4, meshless):
    """The next results after a snapshot: on the mesh-2 server, on a
    meshless server restored from its snapshot, on a (2, 2) mesh joined
    over ``data`` (k = 2) and over both axes (k = 4) restored from it, and
    a (2, 2)-over-``data`` server's own snapshot restored over both axes:
    all equal the meshless server's."""
    want = meshless["next"]
    assert len(want) == 5      # 3 requests and 2 plan nodes
    assert mesh2["next"] == want
    assert restored_results(_meshless, mesh2["snapshot"]) == want
    for axes, got in mesh4["restored"].items():
        assert got == want, axes
    assert mesh4["own_next"] == want
    assert mesh4["own_restored"] == want


@pytest.mark.parametrize("axes", [("data",), ("data", "model")],
                         ids=["data", "both"])
@pytest.mark.parametrize("name", [c["name"] for c in STREAMS])
def test_layout_stream_bit_identical_to_meshless(axes, name, mesh4,
                                                 meshless):
    """A (2, 2) mesh streams joined over ``data`` (k = 2, each block on
    two ranks) and over both axes (k = 4): every window equals the
    meshless one bit for bit, and rank 0's scatters are each sub-window's
    rows once and each plain window once, a block to each of the 3 other
    ranks (the session's model)."""
    got, want = mesh4["streams"][axes][name], meshless["streams"][name]
    assert [x["w"] for x in got["windows"]] \
        == [x["w"] for x in want["windows"]] != []
    for g, w in zip(got["windows"], want["windows"]):
        same_window(g, w)
        assert g["dropped"] == 0.0
    assert got["sigma"] == want["sigma"]
    k, world = len(axes) * 2, 4
    n_subs = got["windows"][-1]["w"] + 4
    subs = 2 * 12 * SUB // k * (world - 1) * n_subs
    model = 0 if name == "kern" else 2 * 12 * 4 * SUB // k * (world - 1)
    assert got["scatter_model"] == model
    assert got["scattered"] == subs + len(got["windows"]) * model
    assert len(got["word_ids"]) == 3 * 2
    for rids, words in got["live"]:
        assert rids == [] and words == got["word_ids"]


@pytest.mark.parametrize("mesh", [2, 4], indirect=True, ids=["k2", "k4"])
def test_workers_dropped_every_server(mesh):
    """Every server of the spawn shut down on the workers (the dead
    replica's included) before their loop closed."""
    for rep in mesh["workers"]:
        assert rep.open == ()
        assert len(rep.ops) > 5
