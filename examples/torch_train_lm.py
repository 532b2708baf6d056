"""End-to-end training with the PyTorch port, as ``examples/train_lm.py``
does it, on the card: plan a batch mixture with ApproxJoin, then train a
~100M-parameter qwen3-family model (12 layers, d_model 640, vocab 32,768)
for a few hundred steps on the deterministic structured stream, with
checkpoints and elastic restore.  ``--small`` runs the same path at toy
width.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--small]
      [--steps N] [--ckpt-dir DIR] [--device cpu]
"""

import argparse
import dataclasses
import shutil
import tempfile

import numpy as np

from repro_torch.core.budget import QueryBudget
from repro_torch.core.relation import relation
from repro_torch.data.pipeline import mixture_shard_counts, plan_batch_mixture
from repro_torch.launch.mesh import check_device
from repro_torch.launch.train import run as train_run
from repro_torch.models import ARCHS


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="LM training with an "
                                 "ApproxJoin-planned batch mixture")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one, removed at the end)")
    ap.add_argument("--device", default="cuda",
                    help="the CUDA card (default) or 'cpu'")
    args = ap.parse_args(argv)
    where = check_device(args.device, "torch_train_lm")
    dev = args.device
    print(f"on {where}")

    # 1) plan the batch mixture with the paper's operator: join a document
    #    weight table against a domain table within an error budget.
    rng = np.random.default_rng(0)
    docs = relation(rng.integers(0, 16, 8192).astype(np.uint32),
                    rng.random(8192).astype(np.float32), device=dev)
    domains = relation(np.arange(16, dtype=np.uint32),
                       np.ones(16, np.float32), device=dev)
    plan = plan_batch_mixture(docs, domains, QueryBudget(error=0.05))
    counts = mixture_shard_counts(plan, batch=8)
    print(f"[mixture] {len(plan.weights)} domains via ApproxJoin "
          f"(estimate {plan.estimate:.1f} +/- {plan.error_bound:.1f}); "
          f"per-batch seq counts = {counts.tolist()}")

    # 2) train: ~100M params (12 layers, d 640, vocab 32k) or toy width.
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="torch_train_lm-")
    try:
        if args.small:
            out = train_run("qwen3-1.7b", steps=args.steps, batch=8, seq=64,
                            reduced=True, ckpt_dir=ckpt_dir, ckpt_every=100,
                            device=dev)
        else:
            cfg100m = dataclasses.replace(
                ARCHS["qwen3-1.7b"], n_layers=12, d_model=640, n_heads=10,
                n_kv_heads=5, head_dim=64, d_ff=2560, vocab=32768,
                attn_chunk=None)
            ARCHS["qwen3-100m"] = cfg100m
            try:
                out = train_run("qwen3-100m", steps=args.steps, batch=4,
                                seq=128, reduced=False, ckpt_dir=ckpt_dir,
                                ckpt_every=100, log_every=10, device=dev)
            finally:
                del ARCHS["qwen3-100m"]
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    if not out["losses"]:
        raise SystemExit(f"[train_lm] nothing to train: {ckpt_dir} already "
                         f"holds step {out['start']}")
    print(f"[train_lm] loss {out['first_loss']:.4f} -> "
          f"{out['final_loss']:.4f} over {len(out['losses'])} steps")
    if not out["final_loss"] < out["first_loss"]:
        raise SystemExit("[train_lm] the loss did not decrease")
    print("[OK] the loss decreased")


if __name__ == "__main__":
    main()
