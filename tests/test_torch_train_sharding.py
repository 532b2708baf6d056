"""The port's sharding rules and the ApproxJoin batch mixture beside the
JAX package's.

``spec_for`` gives the reference's ``PartitionSpec`` entries, and
``param_axes`` / ``cache_axes`` its logical axes at every path of its
layout, for every arch at full size (a ``Model`` on the ``meta`` device),
on the meshes {data: 16, model: 16} and {pod: 2, data: 16, model: 16}.
The mixture plan's domains and counts are equal, its weights within rtol
1e-5 (float32 estimates).
"""

import jax
import numpy as np
import pytest

from repro.core import QueryBudget as JBudget
from repro.core.relation import relation as jrelation
from repro.data import pipeline as JP
from repro.models import ARCHS as JARCHS
from repro.models import Model as JModel
from repro.sharding import axes as JX
from repro.sharding.specs import DEFAULT_RULES as JRULES
from repro.sharding.specs import spec_for as jspec_for
from repro_torch.core.budget import QueryBudget
from repro_torch.core.relation import relation
from repro_torch.data import pipeline as TP
from repro_torch.models import ARCHS, Model
from repro_torch.sharding import (DEFAULT_RULES, cache_axes, is_axes_leaf,
                                  param_axes, spec_for)
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


class FakeMesh:
    """What the reference's ``spec_for`` reads of a mesh: its shape."""

    def __init__(self, shape):
        self.shape = shape


def _norm(spec) -> tuple:
    """A spec's entries as ``PartitionSpec`` compares them: a one-axis tuple
    is that axis."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in spec)


def _flat(tree) -> dict:
    """{dotted path: leaf} of a reference tree (dict keys, field names)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_axes_leaf)[0]:
        out[".".join(str(getattr(p, "key", getattr(p, "name", "")))
                     for p in path)] = leaf
    return out


def test_rules_equal_the_references():
    assert DEFAULT_RULES == JRULES


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("names,shape", [
    (("ff",), (4864,)), (("ff",), (4863,)), (("vocab", "embed"), (51865, 768)),
    (("vocab", "embed"), (151936, 896)), (("batch", None), (256, 128)),
    (("batch", None), (1, 128)), (("batch",), (256,)),
    ((("heads", 14), "embed"), (896, 896)),
    ((("expert", 60), None, "ff"), (60, 64, 1408)),
    (("layers", ("expert", 64), "ff", None), (2, 64, 1408, 2048)),
    (("kv_seq", "model_missing"), (4096, 8))])
def test_spec_for_equals_the_references(mesh, names, shape):
    want = jspec_for(names, shape, FakeMesh(mesh), JRULES)
    assert _norm(spec_for(names, shape, mesh)) == _norm(want)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_and_cache_axes_equal_the_references(arch):
    cfg = JARCHS[arch]
    jm = JModel(cfg)
    shapes = _flat(jax.eval_shape(jm.init, jax.random.key(0)))
    tm = Model(ARCHS[arch], device="meta")
    for with_cfg in (None, cfg):
        want = _flat(JX.param_axes(jax.eval_shape(jm.init,
                                                  jax.random.key(0)),
                                   with_cfg))
        got = param_axes(tm, None if with_cfg is None else ARCHS[arch])
        assert got == want
        for mesh in MESHES:
            for path, names in got.items():
                assert _norm(spec_for(names, shapes[path].shape, mesh)) \
                    == _norm(jspec_for(names, shapes[path].shape,
                                       FakeMesh(mesh), JRULES)), path
    want = _flat(JX.cache_axes(jm.cache_shape(2, 64)))
    assert cache_axes(tm.cache_shape(2, 64)) == want


def test_mixture_plan_and_counts_equal_the_references():
    """``tests/test_data_pipeline.py::test_mixture_plan_and_counts``'s data
    through both packages: the same domains and counts, the weights within
    rtol 1e-5."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 32, 2048).astype(np.uint32)
    vals = rng.random(2048).astype(np.float32)
    dom_k, dom_v = np.arange(32, dtype=np.uint32), np.ones(32, np.float32)
    want = JP.plan_batch_mixture(jrelation(keys, vals),
                                 jrelation(dom_k, dom_v), JBudget(error=0.1))
    got = TP.plan_batch_mixture(relation(keys, vals, device="cpu"),
                                relation(dom_k, dom_v, device="cpu"),
                                QueryBudget(error=0.1))
    np.testing.assert_array_equal(got.domain_keys, want.domain_keys)
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-5)
    assert abs(got.weights.sum() - 1.0) < 1e-5
    assert abs(got.estimate - want.estimate) <= 1e-5 * abs(want.estimate)
    for batch in (8, 64, 1000):
        np.testing.assert_array_equal(
            TP.mixture_shard_counts(got, batch),
            JP.mixture_shard_counts(want, batch))
