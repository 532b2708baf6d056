"""The port's expert-parallel MoE against the JAX package's, on gloo CPU
ranks.

The JAX side runs in one subprocess (``tests/torch_moe_ep_jax.py``, 8 host
devices): the jitted ``moe_ffn_ep`` under ``logical_rules`` on the meshes
(data, model) (1, 2) and (1, 4) (block-EP, 8 experts), (1, 4) with 6
experts (ffe-TP) and (2, 2) (DP x EP), and the jitted meshless ``moe_ffn``,
each at capacity factor 1.25 (tokens drop: a shared offset skews the
loads) and 8 (none), in float32 compute, on x of [4, 1024] tokens (N * K
= 8192 > 4096, so the global capacity rule drops where a data rank's own
4096 would not).  The port's ranks take the same weights cut by
``spec_for``, and this data rank's rows:

* ``moe_ffn_ep`` equals the reference's: ``y`` within 1e-5 of its scale,
  the load-balance loss within 1e-6, the overflow equal as an integer;
* ``moe_ffn`` under the same binding is the meshless function (the global
  rule over the data ranks): the same tolerances against the jitted
  meshless ``moe_ffn``;
* every shard has the shape ``spec_for`` gives, every model rank the same
  outputs.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.sharding.specs import local_shape
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_dist import spawn
from torch_train_ranks import moe_ep_rank

ROOT = Path(__file__).resolve().parents[1]
Y_TOL, AUX_TOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def jax_cases(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_ep_jax")
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_moe_ep_jax.py"),
         str(out)], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 0 and "MOE-EP-JAX-OK" in run.stdout, \
        run.stderr[-3000:]
    return out


def _check(cases, ranks, out) -> None:
    for i, (name, shape, _, cf) in enumerate(cases):
        shape = tuple(shape)
        want = np.load(out / f"{name}.npz")
        for r in ranks:
            got = r[i]
            lo, hi = got["rows"]
            for k, spec in got["specs"].items():
                assert got["shapes"][k] == local_shape(
                    spec, want["w." + k].shape,
                    {"data": shape[0], "model": shape[1]}), (name, k)
            for tag in ("_ep", ""):
                y = want["y" + tag]
                err = np.abs(got["y" + tag] - y[lo:hi]).max() \
                    / np.abs(y).max()
                assert err <= Y_TOL, (name, tag, err)
                assert abs(got["aux" + tag] - float(want["aux" + tag])) \
                    <= AUX_TOL, (name, tag, got["aux" + tag])
                assert got["ovf" + tag] == int(want["ovf" + tag]), \
                    (name, tag, got["ovf" + tag], want["ovf" + tag])
            if cf < 2:
                assert got["ovf_ep"] > 0 and got["ovf"] > 0, name
            else:
                assert got["ovf_ep"] == 0 and got["ovf"] == 0, name


@pytest.mark.parametrize("world", [2, 4])
def test_moe_ep_matches_the_jitted_reference(world, jax_cases, tmp_path):
    every = json.loads((jax_cases / "cases.json").read_text())
    cases = [c for c in every if c[1][0] * c[1][1] == world]
    ranks = spawn(moe_ep_rank, world,
                  ([(str(jax_cases / f"{n}.npz"), tuple(s), e, cf)
                    for n, s, e, cf in cases],),
                  tmp_path, mesh_shape=(1, world))
    _check(cases, ranks, jax_cases)
    # the specs the cases name: block-EP shards the experts, ffe-TP ffe
    specs = {n: ranks[0][i]["specs"]["wg"] for i, (n, *_) in
             enumerate(cases)}
    for n, spec in specs.items():
        assert spec == ((None, None, "model") if n.startswith("ffe")
                        else ("model", None, None)), (n, spec)
