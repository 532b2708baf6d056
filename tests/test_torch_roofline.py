"""The port's roofline helpers and report (``launch/roofline.py``,
``launch/report.py``) against the JAX package's, checked exactly.

* ``model_flops_for`` of all ten configs x {train, prefill, decode} x tp in
  {1, 2, 16}, and ``ep_moe_correction`` of the MoE configs, from each
  package's own config;
* ``count_params`` (total, active) of all ten at full width: the JAX
  package's over ``jax.eval_shape(model.init)``, the port's over its
  ``meta`` model;
* the ring multipliers: one collective of each kind through the port's
  census (rank 0 of 8 fake ranks) against the JAX package's
  ``collective_bytes`` of an HLO module this test writes with the same
  operands;
* ``report.table`` and ``report.deltas``: the same strings from the same
  records (ok, skipped and failed; single- and multi-pod; with and without
  ``mac_fix``);
* ``launch.mesh.fake_ranks`` refuses a second default group and leaves
  none behind.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.launch import report as JREP
from repro.launch import roofline as JRL
from repro.models import ARCHS as JARCHS
from repro.models import Model as JModel
from repro_torch.configs import SHAPES
from repro_torch.core import distributed as D
from repro_torch.launch import report as TREP
from repro_torch.launch import roofline as TRL
from repro_torch.launch.mesh import fake_ranks, make_host_mesh
from repro_torch.models import ARCHS as TARCHS
from repro_torch.models import Model as TModel
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}


@pytest.mark.parametrize("arch", sorted(TARCHS))
def test_model_flops_and_ep_correction(arch):
    jc, tc = JARCHS[arch], TARCHS[arch]
    for kind, shape in KINDS.items():
        cell = SHAPES[shape]
        for tp in (1, 2, 16):
            n = (1_000_003 * tp, 250_001 * tp)
            assert TRL.model_flops_for(tc, *n, kind, cell.batch, cell.seq) \
                == JRL.model_flops_for(jc, *n, kind, cell.batch, cell.seq)
            if tc.moe:
                assert TRL.ep_moe_correction(tc, kind, cell.batch, cell.seq,
                                             256, tp) == \
                    JRL.ep_moe_correction(jc, kind, cell.batch, cell.seq,
                                          256, tp)


@pytest.mark.parametrize("arch", sorted(TARCHS))
def test_count_params_matches_eval_shape(arch):
    shapes = jax.eval_shape(JModel(JARCHS[arch]).init, jax.random.key(0))
    want = JRL.count_params(shapes, JARCHS[arch])
    got = TRL.count_params(TModel(TARCHS[arch], device="meta"),
                           TARCHS[arch])
    assert got == want
    if TARCHS[arch].moe:
        assert got[1] < got[0]


def _hlo(kind: str, k: int, n: int) -> str:
    """A one-collective HLO module over f32[n] operands on k devices."""
    group = "replica_groups={{" + ",".join(map(str, range(k))) + "}}"
    out = {"all-gather": n * k, "all-reduce": n, "reduce-scatter": n // k,
           "all-to-all": n}[kind]
    return (f"HloModule m\n\nENTRY %main {{\n"
            f"  %p = f32[{n}]{{0}} parameter(0)\n"
            f"  ROOT %c = f32[{out}]{{0}} {kind}(f32[{n}]{{0}} %p), "
            f"{group}, dimensions={{0}}\n}}\n")


def test_ring_multipliers_match_collective_bytes():
    k, n = 8, 1024
    x = torch.ones(n)
    with fake_ranks(k):
        group = make_host_mesh(1, k).get_group("model")
        D.COMM.reset()
        D.all_gather_group(x, group)
        D.all_reduce(x, group)
        D.reduce_scatter_group(x, group, 0)
        D.all_to_all_group(x.reshape(k, -1), group)
        census = D.COMM.census()
    got = {c["kind"]: c["bytes"] for c in census}
    assert all(c["calls"] == 1 and c["group"] == k and c["intra_node"]
               for c in census)
    for kind, name in (("all-gather", "all_gather"),
                       ("all-reduce", "all_reduce"),
                       ("reduce-scatter", "reduce_scatter"),
                       ("all-to-all", "all_to_all")):
        want = JRL.collective_bytes(_hlo(kind, k, n), k)
        assert want.count_by_kind[kind] == 1
        assert got[name] == want.bytes_by_kind[kind], kind
    stats = TRL.collective_stats(census)
    assert stats.nvlink_bytes == sum(got.values()) and stats.network_bytes == 0


def _records(tmp_path) -> tuple:
    """Two directories of dry-run records (baseline, optimized)."""
    rng = np.random.default_rng(0)
    base, opt = tmp_path / "base", tmp_path / "opt"
    base.mkdir()
    opt.mkdir()
    archs = ("qwen3-1.7b", "qwen2-0.5b", "whisper-small")
    for d, scale in ((base, 1.0), (opt, 0.5)):
        for arch in archs:
            for shape in ("train_4k", "long_500k"):
                for mesh in ({"data": 16, "model": 16},
                             {"pod": 2, "data": 16, "model": 16}):
                    rec = {"arch": arch, "shape": shape, "mesh": mesh}
                    if shape == "long_500k":
                        rec.update(status="skipped", reason="quadratic")
                    else:
                        t = rng.uniform(0.01, 2.0, 3) * scale
                        rec.update(status="ok", roofline={
                            "compute_s": t[0], "memory_s": t[1],
                            "collective_s": t[2],
                            "dominant": ("compute", "memory",
                                         "collective")[int(np.argmax(t))],
                            "useful_fraction": rng.uniform(0, 1)})
                    tag = "multi" if "pod" in mesh else "single"
                    with open(d / f"{arch}__{shape}__{tag}.json", "w") as f:
                        json.dump(rec, f)
    with open(opt / "gemma2-9b__train_4k__single.json", "w") as f:
        json.dump({"arch": "gemma2-9b", "shape": "train_4k",
                   "mesh": {"data": 16, "model": 16}, "status": "failed",
                   "error": "boom"}, f)
    return str(base), str(opt)


def test_report_tables_match(tmp_path):
    base, opt = _records(tmp_path)
    for mac_fix in (True, False):
        jb, tb = JREP.load(base, mac_fix), TREP.load(base, mac_fix)
        for mesh in ("single", "multi"):
            assert TREP.table(tb, mesh) == JREP.table(jb, mesh)
        jo, to = JREP.load(opt, False), TREP.load(opt, False)
        assert TREP.deltas(tb, to) == JREP.deltas(jb, jo)
        assert "|" in TREP.deltas(tb, to).splitlines()[-1]
        # a failed record has no roofline: both tables refuse it alike
        with pytest.raises(KeyError) as want:
            JREP.table(jo, "single")
        with pytest.raises(KeyError) as got:
            TREP.table(to, "single")
        assert str(got.value) == str(want.value)
        assert TREP.table(to, "multi") == JREP.table(jo, "multi")


def test_fake_ranks_owns_its_group():
    """``fake_ranks`` refuses to start beside a default group and leaves
    none behind, even when its block raises."""
    import torch.distributed as dist
    with fake_ranks(4):
        assert dist.get_world_size() == 4 and dist.get_rank() == 0
        with pytest.raises(RuntimeError, match="already exists"):
            with fake_ranks(4):
                pass
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with fake_ranks(2):
            raise ValueError("inside")
    assert not dist.is_initialized()
