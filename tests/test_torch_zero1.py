"""ZeRO-1 on gloo CPU ranks (``launch/mesh.run_ranks``): AdamW's slots cut
over the data dim (``sharding.specs.slot_specs``, ``optim.adamw.Zero1``).

* the sharded AdamW on 2 and 4 ranks against the JAX package's
  ``adamw_update`` on the mean of the ranks' grads: two updates, clipped
  and not, over leaves whose ``embed`` dim is cut at dim 0 and at dim 1,
  one whose ``embed`` dim does not divide and one without one; params,
  the gathered ``m`` and ``v`` within rtol 1e-6, atol 1e-6 of the leaf's
  scale, the grad norm within 1e-6 (as ``test_torch_train.py``'s
  one-process update);
* ZeRO-1 train steps of reduced ``qwen2-0.5b`` at (data, model) = (2, 1)
  and of reduced ``falcon-mamba-7b`` and ``qwen2-moe-a2.7b`` at (2, 2),
  against plain DP on the same ranks: losses, ``m`` and ``v`` within rtol
  1e-5 (atol 1e-5 of the leaf's scale), params within rtol 1e-5, atol 1e-6
  (the same sums, the norm's squares grouped otherwise: a bias that starts
  at 0 moves by steps of about lr whose size follows grads below AdamW's
  eps, and such an element of a k bias read 1.09e-4 of its leaf's scale,
  2.5e-8 apart); against one process within the DP tolerances (rtol 5e-3,
  atol 5e-4); each rank's slots are the whole
  moments cut by ``shard_of`` under ``slot_specs`` (Mamba's ``in_proj``:
  this data rank's ``embed`` rows of ``[x_r | z_r]``), the whole slots'
  bytes less (k - 1) / k of the cut leaves'; the reduce_scatter and
  all_gather carry what plain DP's all_reduce of those leaves did;
* checkpoints: a ZeRO-1 checkpoint at dp 2 resumed plain in one process,
  a plain one resumed by ZeRO-1 at dp 2, both against a straight run, and
  the ZeRO-1 checkpoint restored by the JAX package's
  ``restore_checkpoint``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ARCHS as JARCHS
from repro.models import Model as JModel
from repro.optim import adamw as JA
from repro.runtime import checkpoint as JCK
from repro.runtime.train import train_state_init as jstate_init
from repro_torch.models import ARCHS
from repro_torch.runtime import checkpoint as TCK
from repro_torch.sharding.specs import shard_of
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_dist import spawn
from torch_train_ranks import train_span, zero1_adamw_rank

RTOL, ATOL = 5e-3, 5e-4
CFG = ARCHS["qwen2-0.5b"].reduced(vocab=128)
AXES = {"wq": ("embed", "heads"), "wo": ("heads", "embed"),
        "odd": ("embed", None), "b": (None,)}
SHAPES = {"wq": (16, 12), "wo": (6, 8), "odd": (9, 5), "b": (7,)}
GSCALES = (1e-3, 10.0)


def _case(world: int, gscale: float, seed: int):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [[{k: (rng.normal(0, 1, s) * gscale).astype(np.float32)
               for k, s in SHAPES.items()} for _ in range(world)]
             for _ in range(2)]
    return params, AXES, grads


@pytest.fixture(scope="module")
def adamw_runs(tmp_path_factory):
    """{world: (cases, each rank's results)}."""
    out = {}
    for world in (2, 4):
        cases = [_case(world, g, i) for i, g in enumerate(GSCALES)]
        out[world] = (cases, spawn(zero1_adamw_rank, world, (cases,),
                                   tmp_path_factory.mktemp(f"w{world}")))
    return out


@pytest.mark.parametrize("gscale", GSCALES)
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_adamw_matches_the_references_on_the_mean(world, gscale,
                                                          adamw_runs):
    cases, ranks = adamw_runs[world]
    i = GSCALES.index(gscale)
    params, _, grads = cases[i]
    want_slots = {"wq": (16 // world, 12), "wo": (6, 8 // world),
                  "odd": (9, 5), "b": (7,)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = JA.adamw_init(jp)
    jlr = JA.cosine_schedule(1e-2, 1, 10)
    for u, g in enumerate(grads):
        mean = {k: sum(r[k] for r in g) / np.float32(world) for k in SHAPES}
        jp, js, jm = JA.adamw_update(
            jp, {k: jnp.asarray(v) for k, v in mean.items()}, js, lr_fn=jlr)
        for rank in ranks:
            got = rank[i]["steps"][u]
            assert rank[i]["slots"] == want_slots
            assert got["lr"] == float(jm["lr"])
            assert abs(got["grad_norm"] - float(jm["grad_norm"])) <= \
                1e-6 * float(jm["grad_norm"])
            for field, tree in (("params", jp), ("m", js.m), ("v", js.v)):
                for k in SHAPES:
                    want = np.asarray(tree[k])
                    np.testing.assert_allclose(
                        got[field][k], want, rtol=1e-6,
                        atol=1e-6 * np.abs(want).max(),
                        err_msg=f"{field} {k} update {u}")


def _moe():
    cfg = ARCHS["qwen2-moe-a2.7b"].reduced(vocab=128)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-0.5b", (2, 1)), ("falcon-mamba-7b", (2, 2)),
    ("qwen2-moe-a2.7b", (2, 2))])
def test_zero1_steps_match_plain_dp(arch, shape, tmp_path):
    cfg = _moe() if arch == "qwen2-moe-a2.7b" else \
        ARCHS[arch].reduced(vocab=128)
    world = shape[0] * shape[1]
    runs = {z: spawn(train_span, world,
                     (cfg, 0, 3, 3, 8, 32, False, None, True, None, z),
                     tmp_path, mesh_shape=shape)
            for z in (False, True)}
    one = train_span(None, "cpu", cfg, 0, 3, 3, 8, 32, float32=True)
    plain, zero1 = runs[False][0], runs[True][0]
    for r in runs[True]:
        assert r["slot_err"] == 0.0
        for k, v in zero1["params"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)
    np.testing.assert_allclose(zero1["losses"], plain["losses"], rtol=1e-5)
    assert zero1["overflow"] == plain["overflow"]
    for field in ("params", "m", "v"):
        for k, w in plain[field].items():
            np.testing.assert_allclose(
                zero1[field][k], w, rtol=1e-5, err_msg=f"{field} {k}",
                atol=1e-6 if field == "params" else 1e-5 * np.abs(w).max())
    for k, w in one["params"].items():
        np.testing.assert_allclose(zero1["params"][k], w, rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(zero1["losses"], one["losses"], rtol=RTOL,
                               atol=ATOL)
    # the ring moves what plain DP's moved: the grads' all_reduce is now a
    # reduce_scatter and an all_gather of the cut leaves and an all_reduce
    # of the rest (the norm's all_reduces aside)
    zc, pc = zero1["comm"], plain["comm"]
    assert zc["zero1_reduce_scatter"]["calls"] == 3
    assert zc["zero1_all_gather"]["calls"] == 3
    # a rank's m and v keep 1 / k of each cut leaf, (k - 1) / k of whose
    # float32 bytes a step's reduce_scatter carries; the others stay whole
    # (the reference's axes name no embed dim in a stacked MLP's weights)
    cut = zc["zero1_reduce_scatter"]["bytes"] // 3
    assert zero1["slot_bytes"] == plain["slot_bytes"] - 2 * cut
    assert 0.5 <= zero1["slot_bytes"] / plain["slot_bytes"] < 0.9

    def total(c):
        return sum(v["bytes"] for op, v in c.items() if op != "grad_norm")
    assert total(zc) == total(pc)
    assert zc["all_reduce"]["bytes"] < pc["all_reduce"]["bytes"]


def test_shard_of_cuts_parts_only_where_they_lie():
    """Mamba's ``in_proj`` slot (``("data", "model")``, ``[x | z]`` over
    ``model``) on rank (1, 0) of a (2, 2) mesh: the second half of the
    rows, and the first half of x's and of z's columns."""
    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (2, 2)

        def get_local_rank(self, axis):
            return {"data": 1, "model": 0}[axis]
    t = torch.arange(4 * 8).reshape(4, 8)
    got = shard_of(t, ("data", "model"), Mesh(), parts=2)
    np.testing.assert_array_equal(got.numpy(), t[2:, [0, 1, 4, 5]].numpy())


def test_zero1_checkpoints_resume_plain_and_in_the_jax_package(tmp_path):
    zck, pck = str(tmp_path / "zero1"), str(tmp_path / "plain")
    two = spawn(train_span, 2, (CFG, 0, 3, 6, 8, 32, False, zck, True, None,
                                True), tmp_path)
    assert two[0]["written"] == 3
    first = train_span(None, "cpu", CFG, 0, 3, 6, 8, 32, ckpt_dir=pck,
                       float32=True)
    straight = train_span(None, "cpu", CFG, 0, 6, 6, 8, 32, float32=True)
    # ZeRO-1 at dp 2 -> plain, one process
    one = train_span(None, "cpu", CFG, 3, 6, 6, 8, 32, ckpt_dir=zck,
                     float32=True)
    # plain, one process -> ZeRO-1 at dp 2
    back = spawn(train_span, 2, (CFG, 3, 6, 6, 8, 32, False, pck, True, None,
                                 True), tmp_path)
    for before, got in ((two[0], one), (first, back[0])):
        assert got["start"] == 3
        np.testing.assert_allclose(before["losses"] + got["losses"],
                                   straight["losses"], rtol=RTOL, atol=ATOL)
        for k, w in straight["params"].items():
            np.testing.assert_allclose(got["params"][k], w, rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    # the JAX package restores the ZeRO-1 checkpoint: the port's reading of
    # it bit for bit, within the DP tolerances of the straight run's step 3
    jstate = jstate_init(JModel(JARCHS["qwen2-0.5b"].reduced(vocab=128)),
                         jax.random.key(0))
    restored, _ = JCK.restore_checkpoint(zck, 3, jstate)
    assert jax.tree.structure(restored) == jax.tree.structure(jstate)
    got = {k: np.asarray(v) for k, v in JCK._flatten(restored).items()}
    want, _ = TCK.load_checkpoint(zck, 3)
    plain, _ = TCK.load_checkpoint(pck, 3)
    assert set(got) == set(want) == set(plain)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
        np.testing.assert_allclose(got[k], plain[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
