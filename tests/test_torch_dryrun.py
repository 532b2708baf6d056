"""The port's model dry run (``launch/dryrun.py``) at the production mesh
``(16, 16)``, as rank 0 of 256 fake ranks on ``meta`` tensors, against the
JAX package's layout of the same parameters on 256 host devices
(``tests/torch_dryrun_jax.py``, ``param_specs``, nothing compiled).

Cells: ``qwen3-1.7b`` ``train_4k``, ``qwen2-moe-a2.7b`` ``prefill_32k``,
``falcon-mamba-7b`` ``long_500k``, ``qwen2-0.5b`` ``train_4k`` under its
``seq`` rule (sequence parallel), and ``qwen3-1.7b`` ``long_500k``, which
is skipped with the reference's reason.  For each cell that runs:

* every parameter's shard on rank 0 has the reference's shard shape, leaf
  by leaf (the port's stacks stacked), and the record's argument bytes are
  those shards' (float32; with AdamW's two moments and its step for train)
  plus the step's inputs;
* ``n_params``, ``n_active`` and ``model_flops`` equal the reference's;
* the census holds the collectives the cell's layout implies: grads
  all_reduced over ``data`` and sequence-parallel reduce_scatters and
  all_gathers under the ``seq`` rule, every group spanning nodes.

Under ``--zero1`` (``qwen3-1.7b`` and ``qwen2-moe-a2.7b`` ``train_4k`` at
``(16, 16)``, ``qwen3-1.7b`` ``train_4k`` at ``(2, 16, 16)``, rank 0 of 512
fake ranks): every AdamW slot's shard on rank 0 has the reference's shard
shape under ``ZERO1_RULES``, leaf by leaf; the argument bytes are the
parameters' shards, the two slots' and the step, plus the batch; the census
holds a reduce_scatter and an all_gather over the 16-rank ``data`` group
(and an all_reduce over the 2 pods), and the collective bytes a rank are
within 1% of the plain cell's.
"""

import json
import math
import os
import subprocess
import sys

import pytest

from repro.configs.shapes import applicable as japplicable
from repro.launch import roofline as JRL
from repro.models import ARCHS as JARCHS
from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import fake_ranks, make_production_mesh
from repro_torch.models import ARCHS, Model
from repro_torch.models.convert import is_stacked, reference_groups
from repro_torch.sharding.specs import logical_rules, shard_params
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

CELLS = (("qwen3-1.7b", "train_4k"), ("qwen2-moe-a2.7b", "prefill_32k"),
         ("falcon-mamba-7b", "long_500k"), ("qwen2-0.5b", "train_4k"),
         ("qwen3-1.7b", "long_500k"))
# (arch, shape, multi-pod) under --zero1
ZERO1_CELLS = (("qwen3-1.7b", "train_4k", False),
               ("qwen2-moe-a2.7b", "train_4k", False),
               ("qwen3-1.7b", "train_4k", True))
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX package's layouts by arch, {cell: (record, rank 0's
    parameter shapes by reference path)}, {ZeRO-1 cell: (record, rank 0's
    slot shapes by reference path)})."""
    out = str(tmp_path_factory.mktemp("dryjax") / "jax.json")
    archs = sorted({a for a, _ in CELLS})
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [os.path.join(HERE, "..", "src"),
                os.environ.get("PYTHONPATH", "")])}
    subprocess.run([sys.executable, os.path.join(HERE, "torch_dryrun_jax.py"),
                    out, *archs], check=True, env=env, timeout=300)
    with open(out) as f:
        ref = json.load(f)
    got = {}
    with fake_ranks(256):
        mesh = make_production_mesh()
        for arch, shape in CELLS:
            rec = DR.run_cell(arch, shape, mesh, verbose=False)
            model = shard_params(Model(ARCHS[arch], device="meta"), mesh)
            got[(arch, shape)] = (rec, _by_path(
                dict(model.named_parameters())))
    zero1 = {}
    for multi in (False, True):
        with fake_ranks(DR.WORLD[multi]):
            mesh = make_production_mesh(multi_pod=multi)
            for arch, shape, mp in ZERO1_CELLS:
                if mp != multi:
                    continue
                rec = DR.run_cell(arch, shape, mesh, verbose=False,
                                  zero1=True)
                with logical_rules(mesh):
                    cell = DR.build_cell(ARCHS[arch], SHAPES[shape], mesh,
                                         {}, zero1=True)
                zero1[(arch, shape, mp)] = (rec, _by_path(
                    cell.args["state"].opt.m))
    return ref, got, zero1


def _by_path(named: dict) -> dict:
    """``{reference path: shape}`` of ``{port name: tensor}`` (the stacks
    stacked)."""
    return {path: ([len(g)] if is_stacked(g[0]) else [])
            + list(named[g[0]].shape)
            for path, g in reference_groups(named).items()}


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_cell_matches_the_reference_layout(cell, runs):
    ref, got, _ = runs
    arch, shape = cell
    rec, shards = got[cell]
    ok, why = japplicable(JARCHS[arch], shape)
    if not ok:
        assert rec["status"] == "skipped" and rec["reason"] == why
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["rules_bound"] == dict(ARCHS[arch].rules or ())
    want = ref[arch]["shards"]
    assert shards == want
    n = sum(math.prod(s) for s in want.values())
    kind = SHAPES[shape].kind
    args = rec["memory"]["argument_bytes"]
    if kind == "train":           # params, m, v float32; step int32; batch
        cellb = SHAPES[shape]
        rows = cellb.batch // 16
        assert args == 3 * 4 * n + 4 + 2 * rows * cellb.seq * 4
    else:                         # params float32; the batch or the cache
        assert args > 4 * n
    roof = rec["roofline"]
    total, active = ref[arch]["counts"]
    assert (roof["n_params"], roof["n_active"]) == (total, active)
    c = SHAPES[shape]
    assert roof["model_flops"] == JRL.model_flops_for(
        JARCHS[arch], total, active, kind, c.batch, c.seq)
    census = roof["census"]
    assert all(not e["intra_node"] and e["group"] == 16 for e in census)
    kinds = {e["kind"] for e in census}
    if kind == "train":
        assert "all_reduce" in kinds
    if ARCHS[arch].rules:
        assert {"reduce_scatter", "all_gather", "all_to_all"} <= kinds
    assert roof["nvlink_bytes_per_device"] == 0
    assert roof["network_bytes_per_device"] == roof["coll_bytes_per_device"]
    assert rec["memory"]["temp_bytes"] > 0


@pytest.mark.parametrize("cell", ZERO1_CELLS, ids=lambda c: f"{c[0]}-{c[1]}"
                         + ("-multipod" if c[2] else ""))
def test_zero1_cell_matches_the_reference_slots(cell, runs):
    ref, got, zero1 = runs
    arch, shape, multi = cell
    rec, slots = zero1[cell]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["zero1"] is True
    tag = "_multipod" if multi else ""
    assert slots == ref[arch]["slots" + tag]
    n = sum(math.prod(s) for s in ref[arch]["shards" + tag].values())
    n_slots = sum(math.prod(s) for s in slots.values())
    assert n_slots < n
    c = SHAPES[shape]
    rows = c.batch * 16 // DR.WORLD[multi]      # a data rank's
    assert rec["memory"]["argument_bytes"] == \
        4 * n + 2 * 4 * n_slots + 4 + 2 * rows * c.seq * 4
    census = rec["roofline"]["census"]
    data = {e["kind"] for e in census if e["group"] == 16}
    assert {"reduce_scatter", "all_gather", "all_reduce"} <= data
    assert any(e["kind"] == "all_reduce" and e["group"] == 2
               for e in census) == multi
    if not multi and (arch, shape) in got:
        plain = got[(arch, shape)][0]["roofline"]["coll_bytes_per_device"]
        coll = rec["roofline"]["coll_bytes_per_device"]
        assert abs(coll - plain) <= 0.01 * plain
