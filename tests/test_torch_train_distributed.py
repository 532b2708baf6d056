"""Data-parallel training on gloo CPU ranks (``launch/mesh.run_ranks``).

* plain DP on 2 ranks, each on its half of the global batch, against one
  process on the whole batch, in float32 compute (in bf16 a half-batch's
  products round elsewhere, and AdamW turns a grad near 0 of either sign
  into a full step): losses and params within rtol 5e-3, atol 5e-4 (the
  reference's tolerances for a changed mesh); the ranks' params equal bit
  for bit;
* elastic restore: 3 steps on 4 ranks, a checkpoint, 3 more on 2 ranks,
  against the port's own straight run at the same tolerances (the
  reference's ``test_elastic_restore_across_mesh_topologies`` is no
  oracle: it fails in the tier-1 runs, ROADMAP C);
* int8-EF: ``ef_compress_grads`` on 2 ranks equals a numpy emulation of
  the reference's float16 formula bit for bit; 20 steps lower the loss with
  live residuals, and the all_reduce carries half the bytes of plain DP's;
* an MoE's capacity under DP is the global batch's (the reference's GSPMD
  program sees it whole): a reduced qwen2-moe on a global [4, 1024] batch
  (N * K = 8192 > 4096, a rank's 4096 would take the loss-free branch), at
  capacity factor 1.0, on 2 ranks against one process: the overflow equal
  and nonzero, losses and params at the tolerances above.
"""

import dataclasses

import numpy as np

from repro.optim.compress import compress_int8 as jcompress
from repro_torch.models import ARCHS
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)
from torch_dist import spawn
from torch_train_ranks import ef_rank, f16_mean, train_span

CFG = ARCHS["qwen2-0.5b"].reduced(vocab=128)
RTOL, ATOL = 5e-3, 5e-4
_MOE = ARCHS["qwen2-moe-a2.7b"].reduced(vocab=128)
MOE = dataclasses.replace(_MOE, moe=dataclasses.replace(
    _MOE.moe, capacity_factor=1.0))


def _close(got: dict, want: dict) -> None:
    for k in want["params"]:
        np.testing.assert_allclose(got["params"][k], want["params"][k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL,
                               atol=ATOL)


def test_plain_dp_two_ranks_match_one(tmp_path):
    ranks = spawn(train_span, 2, (CFG, 0, 4, 4, 8, 32, False, None, True),
                  tmp_path)
    one = train_span(None, "cpu", CFG, 0, 4, 4, 8, 32, float32=True)
    _close(ranks[0], one)
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][k], v)
    n = sum(v.size for v in one["params"].values())
    comm = ranks[0]["comm"]
    assert comm["all_reduce"]["calls"] == 4
    assert comm["all_reduce"]["bytes"] == 4 * (2 * n * 4 // 2)


def test_elastic_restore_four_ranks_to_two(tmp_path):
    ck = str(tmp_path / "ck")
    four = spawn(train_span, 4, (CFG, 0, 3, 6, 8, 32, False, ck, True),
                 tmp_path)
    assert four[0]["written"] == 3
    two = spawn(train_span, 2, (CFG, 3, 6, 6, 8, 32, False, ck, True),
                tmp_path)
    assert two[0]["start"] == 3 and two[0]["written"] == 6
    straight = train_span(None, "cpu", CFG, 0, 6, 6, 8, 32, float32=True)
    _close({"params": two[0]["params"],
            "losses": four[0]["losses"] + two[0]["losses"]}, straight)


def test_ef_compress_equals_the_float16_formula(tmp_path):
    rng = np.random.default_rng(0)
    shapes = {"a": (33, 7), "b": (5,), "c": (2, 3, 4)}
    grads = [{k: rng.normal(0, 10.0 ** -r, s).astype(np.float32)
              for k, s in shapes.items()} for r in range(2)]
    errs = [{k: rng.normal(0, 1e-3, s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(2)]
    got = spawn(ef_rank, 2, (grads, errs), tmp_path)
    for k in shapes:
        payloads, new_e = [], []
        for r in range(2):
            g = grads[r][k] + errs[r][k]
            codes, scale = (np.asarray(x) for x in jcompress(g))
            payloads.append(codes.astype(np.float16)
                            * scale.astype(np.float16))
            new_e.append(g - codes.astype(np.float32) * scale)
        want = f16_mean(payloads)
        for r in range(2):
            np.testing.assert_array_equal(got[r][0][k], want, err_msg=k)
            np.testing.assert_array_equal(got[r][1][k], new_e[r], err_msg=k)


def test_ef_dp_training_lowers_the_loss(tmp_path):
    steps = 20
    cfg = ARCHS["qwen2-0.5b"].reduced(vocab=128, d_model=64, d_ff=128)
    ranks = spawn(train_span, 2, (cfg, 0, steps, steps, 16, 32, True),
                  tmp_path)
    losses = ranks[0]["losses"]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert all(r["ef_abs"] > 0 for r in ranks)
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][k], v)
    n = sum(v.size for v in ranks[0]["params"].values())
    comm = ranks[0]["comm"]
    # float16 on the wire: half the 2 n 4 (k - 1) / k bytes of plain DP
    assert comm["all_reduce"]["bytes"] == steps * (2 * n * 2 // 2)
    assert comm["all_reduce_metrics"]["calls"] == steps


def test_moe_dp_capacity_is_the_global_batchs(tmp_path):
    ranks = spawn(train_span, 2, (MOE, 0, 2, 2, 4, 1024, False, None, True),
                  tmp_path)
    one = train_span(None, "cpu", MOE, 0, 2, 2, 4, 1024, float32=True)
    assert all(o > 0 for o in one["overflow"]), one["overflow"]
    for r in ranks:
        assert r["overflow"] == one["overflow"]
    _close(ranks[0], one)
