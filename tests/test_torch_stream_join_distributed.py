"""The port's streaming server on a mesh of gloo ranks against its meshless
streaming server and the JAX package.

Rank 0 streams (``StreamJoinServer(mesh=...)``) and the other ranks run the
server's worker loop (``torch_dist.stream_rank``), one spawn a mesh size (2
and 4 ranks), every case of that size in it.  The same sessions run on a
meshless server in this process.  In exact-parity every window equals the
meshless one bit for bit (estimate, bound, count, dof, draws, strata keys,
the ORed filter words and the sigma table), on the plain and the kernel
route; under psum within rtol 1e-5, with the rolling overlap below 1.0
planning the buckets and nothing dropped.  The windows also hold against
the JAX package's ``approx_join`` over the same window rows (integers
exactly, estimates and bounds within rtol 1e-4), the ranks keep words only
for the live sub-windows once the stream is drained, the scatter bytes
equal the model, and the per-window accuracy gate passes in both merges
(the counterpart of the reference's ``test_stream_accuracy_gate_mesh_2_4_8``;
psum counts within 2e-2, as there).
"""

import sys

import numpy as np
import pytest

import repro.core.relation  # noqa: F401  (repro.core re-exports a function so named)
from repro.core.budget import QueryBudget as JBudget
from repro.core.cost import SigmaRegistry as JSigma
from repro.core.join import approx_join as japprox_join
from repro_torch.core.distributed import planned_bucket_cap
from repro_torch.core.relation import bucket_capacity
from repro_torch.runtime.stream_join import StreamJoinServer
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_dist import same_window, spawn, stream_rank, stream_windows

jrel = sys.modules["repro.core.relation"]

MS, BM, SUB = 1024, 256, 512
RTOL = 1e-5


def _arrays(seed, n=400):
    r = np.random.default_rng(seed)
    return [(r.integers(0, 200, n).astype(np.uint32),
             r.normal(10, 2, n).astype(np.float32)),
            (r.integers(150, 350, n).astype(np.uint32),
             r.normal(5, 1, n).astype(np.float32))]


BATCHES = [_arrays(3000 + i) for i in range(7)]


def _case(name, spec=(4, 1, SUB), budget=(None, 0.5), mode="exact-parity",
          kernels=False):
    return dict(name=name, spec=spec, budget=budget, mode=mode,
                kernels=kernels, ms=MS, bm=BM, seed=3, batches=BATCHES)


# sliding windows in both merges and on the kernel route, and tumbling
# exact windows
CASES = [_case("slide"), _case("psum", mode="psum"),
         _case("kern", kernels=True), _case("tumble", (2, 2, SUB), ())]
NAMES = [c["name"] for c in CASES]


@pytest.fixture(scope="module")
def meshless():
    return {c["name"]: stream_windows(StreamJoinServer(batch_slots=2), c,
                                      "cpu") for c in CASES}


_SPAWNED: dict = {}


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    def get(k):
        if k not in _SPAWNED:
            got = spawn(stream_rank, k, (CASES, ("exact-parity", "psum")),
                        tmp_path_factory.mktemp("stream"))
            res = got[0]
            _SPAWNED[k] = dict(cases=dict(zip(NAMES, res["cases"])),
                               gates=res["gates"], workers=got[1:])
        return _SPAWNED[k]
    return get


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", ["slide", "kern", "tumble"])
def test_mesh_stream_bit_identical_to_meshless(k, name, mesh, meshless):
    got, want = mesh(k)["cases"][name], meshless[name]
    assert [x["w"] for x in got["windows"]] \
        == [x["w"] for x in want["windows"]] != []
    for g, w in zip(got["windows"], want["windows"]):
        same_window(g, w)
        assert g["dropped"] == 0.0
    assert got["sigma"] == want["sigma"]
    for f in ("filter_builds", "filter_cache_hits"):
        assert got["diag"][f] == want["diag"][f], f
    for f in ("windows_emitted", "windows_served", "retired_filter_words",
              "windows_shed"):
        assert got["sdiag"][f] == want["sdiag"][f], f
    kernels = name == "kern"
    assert got["diag"]["kernel_queries"] == len(got["windows"]) * kernels
    # the kernel route's windows never left rank 0: nothing to gather
    assert got["diag"]["kernel_gather_bytes"] == 0.0
    cls = got["windows"][0]["cls"]
    assert cls[10] == (() if kernels else (("data", k), ("model", 1)))


@pytest.mark.parametrize("k", [2, 4])
def test_mesh_stream_psum_within_rtol(k, mesh, meshless):
    """psum windows agree with the meshless windows within rtol 1e-5, and
    from the second window on their buckets are planned from the rolling
    overlap (below 1.0), smaller than the first window's plan at overlap
    1.0."""
    got, want = mesh(k)["cases"]["psum"], meshless["slide"]
    assert len(got["windows"]) == len(want["windows"]) == 4
    for g, w in zip(got["windows"], want["windows"]):
        assert all(abs(a - b) <= RTOL * max(abs(b), 1e-30)
                   for a, b in zip(g["surface"], w["surface"])), g["w"]
        assert g["dropped"] == 0.0
    assert got["ewma"] is not None and got["ewma"] < 1.0
    caps = [g["cls"][12] for g in got["windows"]]
    local = 4 * SUB // k
    first = min(bucket_capacity(planned_bucket_cap(local, k, 1.0)), local)
    assert caps[0] == first and all(c < first for c in caps[1:])
    assert got["diag"]["dist_dropped_tuples"] == 0.0


@pytest.mark.parametrize("k", [2, 4])
def test_mesh_stream_matches_jax_approx_join(k, mesh):
    """Each sliding window against the JAX package's ``approx_join`` over
    the same window rows (admitted micro-batches in arrival order, padded
    to the window's capacity), its sigma fed window by window: counts and
    draws exactly, estimates and bounds within rtol 1e-4.  The window's
    filter seed differs from its sampling seed, which no strata depend
    on."""
    got = mesh(k)["cases"]["slide"]
    sigma = JSigma()
    for g in got["windows"]:
        w = g["w"]
        rels = []
        for side in range(2):
            keys, vals, valid = [], [], []
            for arr in BATCHES[w:w + 4]:
                kk, vv = arr[side]
                pad = SUB - len(kk)
                keys += [kk, np.zeros(pad, np.uint32)]
                vals += [vv, np.zeros(pad, np.float32)]
                valid += [np.ones(len(kk), bool), np.zeros(pad, bool)]
            rels.append(jrel.relation(np.concatenate(keys),
                                      np.concatenate(vals),
                                      np.concatenate(valid)))
        want = japprox_join(rels, JBudget(error=0.5), seed=3 + 1 + w,
                            max_strata=MS, b_max=BM, sigma_registry=sigma,
                            query_id="slide/stream")
        assert g["surface"][2] == float(want.count)
        np.testing.assert_array_equal(g["n_sampled"],
                                      np.asarray(want.stats.n_sampled))
        np.testing.assert_allclose(g["surface"][:2],
                                   [float(want.estimate),
                                    float(want.error_bound)], rtol=1e-4)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_mesh_stream_ranks_hold_only_live_words(k, name, mesh):
    """Once a stream is drained (and its window requests dropped), every
    rank holds no relation and exactly the words of the live sub-windows:
    3 sub-windows x 2 sides of a sliding window of 4, none of a tumbling
    one; retirement released the rest."""
    got = mesh(k)["cases"][name]
    live = 0 if name == "tumble" else 3 * 2
    assert len(got["word_ids"]) == live
    assert len(got["live"]) == k
    for rids, words in got["live"]:
        assert rids == []
        assert words == got["word_ids"]


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_mesh_stream_scatter_bytes_equal_the_model(k, name, mesh):
    """Rank 0's scatters: each sub-window's rows once for its filter build
    when its first window is emitted (12 bytes a row to each other rank's
    block, both sides), and each plain window once (the session's model,
    both sides)."""
    got = mesh(k)["cases"][name]
    size, slide, _ = next(c["spec"] for c in CASES if c["name"] == name)
    n_subs = got["windows"][-1]["w"] * slide + size
    subs = 12 * SUB * (k - 1) // k * 2 * n_subs
    windows = len(got["windows"]) * got["scatter_model"]
    assert got["scattered"] == subs + windows
    cap = size * SUB
    assert got["scatter_model"] == (0 if name == "kern"
                                    else 2 * 12 * cap * (k - 1) // k)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("mode", ["exact-parity", "psum"])
def test_mesh_stream_accuracy_gate(k, mode, mesh):
    gate = mesh(k)["gates"][mode]
    assert gate["passed"], gate["summary"]
    assert gate["alloc"]
    if mode == "exact-parity":
        assert gate["dropped"] == 0.0
    else:
        # the rolling overlap estimate drove the bucket plan
        assert gate["ewma"] is not None and gate["ewma"] < 1.0


@pytest.mark.parametrize("k", [2, 4])
def test_mesh_stream_workers_served_every_server(k, mesh):
    """One worker loop served every streaming server in turn, and each
    server's shutdown dropped its state there."""
    for rep in mesh(k)["workers"]:
        assert len(rep.ops) == len(CASES) + 2          # cases and gates
        assert min(rep.ops.values()) > 0
        assert rep.open == ()
