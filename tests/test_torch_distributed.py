"""The port's distributed pipeline on gloo ranks against the JAX package.

``bucketize`` runs in this process beside the reference's.  The rest runs
on spawned gloo ranks (``torch_dist``), one spawn a mesh: 1, 2 and 4 ranks
joined over ``data``, and a (2, 2) mesh joined over both axes and over
``data`` alone (rows then repeat over ``model``).  Each rank's
``shuffle_by_key`` must equal the reference's ``jax.vmap`` emulation of the
mesh (as ``tests/test_distributed_props.py`` runs it) row for row, with the
same overflow; ``or_reduce`` must equal one ``bloom.build`` over all the
rows; the gather merge must equal the port's single-device ``approx_join``
bit for bit and the JAX package's within rtol 1e-5 (integers exactly); the
psum merge must agree within rtol 1e-5.  The reference's own mesh server
is no oracle here: its distributed parity test fails (ROADMAP §C).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.relation  # noqa: F401  (repro.core re-exports a function so named)
from repro.core import distributed as jdist
from repro.core import join as jjoin
from repro.core.budget import QueryBudget as JBudget
from repro_torch.core import bloom as tbloom
from repro_torch.core import distributed as tdist
from repro_torch.core import join as tjoin
from repro_torch.core import relation as trel
from repro_torch.core.budget import QueryBudget
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_dist import join_rank, routed_bytes, spawn

jrel = sys.modules["repro.core.relation"]

N = 1 << 12
MS, BM = 1024, 512
RTOL = 1e-5


def _arrays(seed=0, n=N, invalid=0.1):
    rng = np.random.default_rng(seed)
    out = []
    for lo, hi, mu in ((0, 500, 10.0), (400, 900, 5.0)):
        k = (rng.integers(lo, hi, n) * 2654435761 % 2**32).astype(np.uint32)
        v = rng.normal(mu, 2, n).astype(np.float32)
        out.append((k, v, rng.random(n) > invalid))
    return out


DATA = _arrays()
# (bucket cap, routing seed); cap 0: a rank's rows, which cannot overflow
SHUFFLES = ((0, 3), (8, 11))
JOINS = {
    "gather/exact": dict(mode="exact", max_strata=MS, seed=7),
    "gather/budget": dict(mode="sample", budget=QueryBudget(error=0.5),
                          b_max=BM, max_strata=MS, seed=5),
    "gather/fraction": dict(mode="sample", sample_fraction=0.25, b_max=BM,
                            max_strata=MS, seed=9),
    "psum/exact": dict(mode="exact", max_strata=MS, seed=7, merge="psum"),
    "psum/budget": dict(mode="sample", budget=QueryBudget(error=0.5),
                        b_max=BM, max_strata=MS, seed=5, merge="psum"),
    "unfiltered/exact": dict(mode="exact", max_strata=MS, seed=7,
                             filter_stage=False),
    "small-bucket/exact": dict(mode="exact", max_strata=MS, seed=7,
                               bucket_cap=16),
}
# the single-device call each join must reproduce: (budget, kwargs)
SINGLE = {
    "exact": ((), dict(max_strata=MS, seed=7)),
    "budget": ((None, 0.5), dict(max_strata=MS, b_max=BM, seed=5)),
    "fraction": ((None, 0.5, 0.95, 0.25), dict(max_strata=MS, b_max=BM,
                                               seed=9)),
}
MESHES = {                       # name: (mesh shape, join axes)
    "1": ((1, 1), ("data",)),
    "2": ((2, 1), ("data",)),
    "4": ((4, 1), ("data",)),
    "2x2": ((2, 2), ("data", "model")),
    "2x2/data": ((2, 2), ("data",)),
}


def _surface(r):
    return tuple(float(getattr(r, f))
                 for f in ("estimate", "error_bound", "count", "dof"))


def _close(got, want):
    return all(abs(g - w) <= RTOL * max(abs(w), 1e-30)
               for g, w in zip(got, want))


@pytest.fixture(scope="module")
def singles():
    """Each single-device reference: the port's and the JAX package's."""
    out = {}
    trels = [trel.relation(k, v, m, device="cpu") for k, v, m in DATA]
    jrels = [jrel.relation(k, v, m) for k, v, m in DATA]
    for name, (budget, kw) in SINGLE.items():
        t = tjoin.approx_join(trels, QueryBudget(*budget), **kw)
        j = jjoin.approx_join(jrels, JBudget(*budget), **kw)
        out[name] = (_surface(t), _surface(j),
                     float(t.diagnostics.sample_draws),
                     float(j.diagnostics.sample_draws))
    return out


_SPAWNED: dict = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each mesh's rank results, one spawn a world size (the 4-rank meshes
    share theirs)."""
    def get(name):
        world = int(np.prod(MESHES[name][0]))
        if world not in _SPAWNED:
            names = [n for n, (s, _) in MESHES.items()
                     if int(np.prod(s)) == world]
            _SPAWNED[world] = dict(zip(names, zip(*spawn(
                join_rank, world,
                (DATA, [MESHES[n] for n in names], SHUFFLES,
                 list(JOINS.values())),
                tmp_path_factory.mktemp("mesh"),
                mesh_shape=MESHES[names[0]][0]))))
        return _SPAWNED[world][name]
    return get


@pytest.mark.parametrize("k,cap", [(k, c) for k in (1, 2, 4, 8)
                                   for c in (1, 3, 8, 64)])
def test_bucketize_equals_reference(k, cap):
    keys, vals, valid = DATA[0]
    keys, vals, valid = keys[:256], vals[:256], valid[:256]
    seed = 7 * k + cap
    jr = jrel.Relation(jnp.asarray(keys), jnp.asarray(vals),
                       jnp.asarray(valid))
    jd = (jdist.hash2(jr.keys, seed) % jnp.uint32(k)).astype(jnp.int32)
    want = jdist.bucketize(jr, jd, k, cap)
    tr = trel.relation(keys, vals, valid, device="cpu")
    got = tdist.bucketize(tr, tdist.hash2(tr.keys, seed) % k, k, cap)
    np.testing.assert_array_equal(got[0].numpy().astype(np.uint32),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3])


@pytest.mark.parametrize("rows,k,overlap", [(1 << 20, 4, 0.1), (64, 8, 1.0),
                                            (1 << 12, 2, 0.05)])
def test_planned_bucket_cap_equals_reference(rows, k, overlap):
    assert tdist.planned_bucket_cap(rows, k, overlap) \
        == jdist.planned_bucket_cap(rows, k, overlap)


def _emulated_shuffle(shape, axes, cap, seed):
    """The reference's shuffle of the first relation on ``shape``, by vmap
    over the join axes: a ``[*sizes, k * cap]`` Relation and overflows."""
    keys, vals, valid = DATA[0]
    sizes = [dict(zip(("data", "model"), shape))[a] for a in axes]
    k = int(np.prod(sizes))
    cap = cap or N // k
    rel = jrel.Relation(*(jnp.asarray(x).reshape(*sizes, -1)
                          for x in (keys, vals, valid)))
    fn = lambda r: jdist.shuffle_by_key(r, k, cap, axes, seed)  # noqa: E731
    for a in reversed(axes):
        fn = jax.vmap(fn, axis_name=a)
    out, sent, ovf = jax.jit(fn)(rel)
    return (jrel.Relation(*(np.asarray(x).reshape(k, -1) for x in out)),
            np.asarray(sent).reshape(-1), np.asarray(ovf).reshape(-1))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shuffle_matches_reference_emulation(mesh, ranks):
    shape, axes = MESHES[mesh]
    got = ranks(mesh)
    for i, (cap, seed) in enumerate(SHUFFLES):
        want, sent, ovf = _emulated_shuffle(shape, axes, cap, seed)
        for r in got:
            b = r["block"]
            (keys, vals, valid), r_sent, r_ovf = r["shuffles"][i]
            np.testing.assert_array_equal(keys.astype(np.uint32),
                                          want.keys[b])
            np.testing.assert_array_equal(vals, want.values[b])
            np.testing.assert_array_equal(valid, want.valid[b])
            assert (r_sent, r_ovf) == (int(sent[b]), int(ovf[b])), (cap, b)
    # every rank holds its block once per model index
    blocks = sorted(r["block"] for r in got)
    repeat = len(got) // int(np.prod([dict(zip(("data", "model"), shape))[a]
                                      for a in axes]))
    assert blocks == sorted(list(range(len(got) // repeat)) * repeat)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_or_reduce_equals_single_build(mesh, ranks):
    for i, (k, _, m) in enumerate(DATA):
        r = trel.relation(k, np.zeros(N, np.float32), m, device="cpu")
        want = tbloom.build(r.keys, r.valid,
                            tbloom.num_blocks_for(N, 0.01), 3).words.numpy()
        for got in ranks(mesh):
            np.testing.assert_array_equal(got["words"][i], want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gather_join_bit_identical_to_approx_join(mesh, ranks, singles):
    joins = dict(zip(JOINS, zip(*[r["joins"] for r in ranks(mesh)])))
    for case in ("gather/exact", "gather/budget", "gather/fraction"):
        port, jax_, draws, jdraws = singles[case.split("/")[1]]
        for got in joins[case]:                 # the same on every rank
            assert got["surface"] == port, (case, got["surface"], port)
            assert got["overflow"] == 0
            # the JAX package: integers exactly, floats within rtol 1e-5
            assert got["surface"][2] == jax_[2]
            assert got["surface"][3] == jax_[3]
            assert _close(got["surface"][:2], jax_[:2]), (case, jax_)
            if case != "gather/exact":
                assert got["draws"] == draws == jdraws


@pytest.mark.parametrize("mesh", list(MESHES))
def test_psum_join_within_rtol(mesh, ranks, singles):
    joins = dict(zip(JOINS, ranks(mesh)[0]["joins"]))
    for case in ("psum/exact", "psum/budget"):
        port = singles[case.split("/")[1]][0]
        got = joins[case]["surface"]
        assert _close(got, port), (case, got, port)
        assert got[2] == port[2]
    assert _close(joins["unfiltered/exact"]["surface"],
                  singles["exact"][0])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_filter_cuts_the_shuffle_and_overflow_is_counted(mesh, ranks):
    joins = dict(zip(JOINS, ranks(mesh)[0]["joins"]))
    filt, unf = joins["gather/exact"], joins["unfiltered/exact"]
    k = len(filt["per_rank"])
    assert sum(filt["per_rank"]) == filt["shuffled"]
    if k == 1:                  # nothing crosses ranks
        assert filt["shuffled"] == unf["shuffled"] == 0
    else:
        assert 0 < filt["shuffled"] < unf["shuffled"]
    small = joins["small-bucket/exact"]
    assert small["overflow"] == sum(small["dropped"]) > 0
    assert small["surface"][2] < filt["surface"][2]     # fewer pairs joined


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shuffled_bytes_equal_what_the_data_routes_off_each_rank(mesh,
                                                                  ranks):
    """Each rank's metered shuffle bytes are the live rows of its block
    whose keys route elsewhere, counted from the data on one device."""
    shape, axes = MESHES[mesh]
    k = int(np.prod([dict(zip(("data", "model"), shape))[a] for a in axes]))
    joins = dict(zip(JOINS, ranks(mesh)[0]["joins"]))
    for case, kw in JOINS.items():
        want = routed_bytes(DATA, k, kw["seed"],
                            kw.get("filter_stage", True))
        assert joins[case]["per_rank"] == want.tolist(), case


@pytest.mark.parametrize("bad_rank", [0, 1])
def test_a_failing_rank_fails_the_run_and_frees_the_others(bad_rank,
                                                           tmp_path):
    """A rank that raises fails the run with its traceback, and the rank
    waiting on it in a collective is killed, not left to its timeout."""
    import time

    from torch_dist import fail_rank
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        spawn(fail_rank, 2, (bad_rank,), tmp_path)
    assert time.monotonic() - t0 < 60
