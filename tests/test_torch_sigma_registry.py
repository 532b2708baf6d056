"""The port's columnar ``SigmaRegistry`` against the dict loops it replaced.

``DictRegistry`` below is the registry as it was (and as the JAX package
still has it): ``{query_id: {int key: float}}`` filled and read one stratum
at a time.  Random sequences of lookups and updates go through both; the
lookups must be equal bit for bit, the tables equal as dicts and in key
order, and the saved JSON equal byte for byte after every step."""

import json
import pickle

import numpy as np
import pytest

from repro.core import cost as jcost
from repro_torch.core.cost import QuerySigmas, SigmaRegistry
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

SENTINEL = 0xFFFFFFFF
QUERIES = ("t0/q", "t1/q", "never")      # "never" is only looked up


class DictRegistry:
    """The oracle: the per-stratum Python loops."""

    def __init__(self, table=None):
        self.table = {} if table is None else table

    def lookup(self, query_id, keys, default=1.0):
        q = self.table.get(query_id, {})
        return np.asarray([q.get(int(k), default) for k in keys], np.float32)

    def has(self, query_id):
        return query_id in self.table

    def update(self, query_id, keys, sigmas, valid):
        q = self.table.setdefault(query_id, {})
        for k, s, v in zip(np.asarray(keys), np.asarray(sigmas),
                           np.asarray(valid)):
            if v:
                q[int(k)] = float(s)

    def save(self, path):
        with open(path, "w") as fh:
            json.dump({q: {str(k): v for k, v in t.items()}
                       for q, t in self.table.items()}, fh)

    @classmethod
    def load(cls, path):
        with open(path) as fh:
            raw = json.load(fh)
        return cls({q: {int(k): float(v) for k, v in t.items()}
                    for q, t in raw.items()})


def _pool(rng):
    """Keys a query draws from: the edges of uint32 (SENTINEL among them)
    and random ones, few enough that updates repeat keys."""
    return np.concatenate([[0, 1, 1 << 31, SENTINEL - 1, SENTINEL],
                           rng.integers(0, 1 << 32, 195)]).astype(np.int64)


def _ops(seed: int) -> list:
    """A random sequence of ``("update", qid, keys, sigmas, valid)`` and
    ``("lookup", qid, keys, default)``: repeated keys within an update,
    invalid entries, empty updates, unequal lengths (zip's shortest),
    int64, uint32 and list keys, misses and a query never updated."""
    rng = np.random.default_rng(seed)
    pool = _pool(rng)
    ops = []
    for _ in range(24):
        qid = QUERIES[rng.integers(2)]
        n = int(rng.choice([0, 1, 7, 64, 300]))
        keys = pool[rng.integers(0, len(pool), n)]
        keys = [keys, keys.astype(np.uint32), keys.tolist()][rng.integers(3)]
        if rng.random() < 0.6:
            sig = rng.gamma(2.0, 2.0, n).astype(np.float32)
            valid = rng.random(n) < 0.7
            cut = int(rng.integers(3))
            if cut and n:                    # one column shorter
                sig, valid = (sig[:-1], valid) if cut == 1 \
                    else (sig, valid[:-1])
            ops.append(("update", qid, keys, sig, valid))
        else:
            qid = QUERIES[rng.integers(3)]
            default = float(rng.choice([1.0, 0.1, 3.7]))
            ops.append(("lookup", qid, keys, default))
    return ops


def _same(reg, oracle, tmp_path):
    """Tables, key order, ``has`` and saved bytes all equal."""
    assert reg.table == oracle.table and oracle.table == reg.table
    assert list(reg.table) == list(oracle.table)
    for q in QUERIES:
        assert reg.has(q) == oracle.has(q)
        if q in oracle.table:
            assert list(reg.table[q]) == list(oracle.table[q])
            assert dict(reg.table[q].items()) == oracle.table[q]
    reg.save(str(tmp_path / "cols.json"))
    oracle.save(str(tmp_path / "dict.json"))
    assert (tmp_path / "cols.json").read_bytes() == \
        (tmp_path / "dict.json").read_bytes()


def _apply(op, regs):
    """Run ``op`` on every registry; a lookup's results as raw bits."""
    kind, qid, keys, *rest = op
    if kind == "update":
        for r in regs:
            r.update(qid, keys, *rest)
        return None
    return [r.lookup(qid, keys, default=rest[0]).view(np.uint32)
            for r in regs]


@pytest.mark.parametrize("seed", range(8))
def test_lookups_and_updates_match_the_dict_loops(seed, tmp_path):
    reg, oracle = SigmaRegistry(), DictRegistry()
    for op in _ops(seed):
        got = _apply(op, (reg, oracle))
        if got is not None:
            assert got[0].dtype == got[1].dtype and got[0].shape == \
                got[1].shape
            np.testing.assert_array_equal(got[0], got[1])
        _same(reg, oracle, tmp_path)
    # load -> update -> save, from the oracle's file
    oracle.save(str(tmp_path / "start.json"))
    reg = SigmaRegistry.load(str(tmp_path / "start.json"))
    oracle = DictRegistry.load(str(tmp_path / "start.json"))
    _same(reg, oracle, tmp_path)
    for op in _ops(seed + 100):
        got = _apply(op, (reg, oracle))
        if got is not None:
            np.testing.assert_array_equal(got[0], got[1])
        _same(reg, oracle, tmp_path)


@pytest.mark.parametrize("seed", range(2))
def test_jax_package_file_loads_updates_and_saves_alike(seed, tmp_path):
    """A file the JAX package's registry wrote loads in the port, and the
    same updates on both keep their saved files byte-identical."""
    jreg = jcost.SigmaRegistry()
    for op in _ops(seed):
        _apply(op, (jreg,))
    path = tmp_path / "jax.json"
    jreg.save(str(path))
    reg = SigmaRegistry.load(str(path))
    reg.save(str(tmp_path / "back.json"))
    assert (tmp_path / "back.json").read_bytes() == path.read_bytes()
    for op in _ops(seed + 50):
        got = _apply(op, (reg, jreg))
        if got is not None:
            np.testing.assert_array_equal(got[0], got[1])
    reg.save(str(tmp_path / "port.json"))
    jreg.save(str(path))
    assert (tmp_path / "port.json").read_bytes() == path.read_bytes()


def test_table_reads_and_writes_as_a_dict_of_dicts():
    reg = SigmaRegistry(table={"a": {7: 0.25, SENTINEL: 1.5}})
    assert SigmaRegistry({"a": {7: 0.25, SENTINEL: 1.5}}) == reg
    assert reg.table == {"a": {7: 0.25, SENTINEL: 1.5}}
    assert "a" in reg.table and "b" not in reg.table and reg.has("a")
    reg.table["b"] = {11: 0.5, 3: 2.0}
    assert isinstance(reg.table["b"], QuerySigmas)
    assert list(reg.table["b"]) == [11, 3]
    assert reg.table["b"][3] == 2.0 and reg.table["b"].get(4) is None
    assert 11 in reg.table["b"] and "11" not in reg.table["b"]
    with pytest.raises(KeyError):
        reg.table["b"][1 << 70]
    assert list(reg.table.keys()) == ["a", "b"]
    assert dict(reg.table.items()) == {"a": {7: 0.25, SENTINEL: 1.5},
                                       "b": {11: 0.5, 3: 2.0}}
    assert reg.table["b"] != {11: 0.5}
    # a mapping read before an update keeps what it held
    before = reg.table["b"]
    assert reg.update("b", np.array([3, 5]), np.array([9.0, 4.0]),
                      np.array([True, True])) == 1
    assert before == {11: 0.5, 3: 2.0}
    assert reg.table["b"] == {11: 0.5, 3: 9.0, 5: 4.0}
    # assigning another query's mapping (as a tenant migration does)
    reg.table["c"] = reg.table["a"]
    assert reg.table["c"] == {7: 0.25, SENTINEL: 1.5}
    del reg.table["a"]
    assert "a" not in reg.table and not reg.has("a")
    np.testing.assert_array_equal(reg.lookup("a", [7]), [1.0])
    back = pickle.loads(pickle.dumps(reg.table))
    assert back == reg.table and list(back["b"]) == [11, 3, 5]


def test_find_counts_hits_and_update_counts_new_keys():
    reg = SigmaRegistry()
    assert reg.update("q", [], [], []) == 0 and reg.has("q")
    assert reg.update("q", [4, 2, 4, 9], [1.0, 2.0, 3.0, 4.0],
                      [True, True, True, False]) == 2
    sig, hits = reg.find("q", np.array([2, 3, 4, 9], np.uint32))
    assert hits == 2
    np.testing.assert_array_equal(sig, np.float32([2.0, 1.0, 3.0, 1.0]))
    assert reg.find("never", [2, 4])[1] == 0
    assert reg.update("q", [9, 2], [5.0, 6.0], [True, True]) == 1
    assert list(reg.table["q"]) == [4, 2, 9]
