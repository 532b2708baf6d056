"""The control of a cell's check: the reference put in the program's place,
computed one precision below the configuration's (bfloat16 for its float32
values), read by the same comparison that decides ``correct``.

    python3 portbench/control.py --workload <cell> --seeds <a,b,c> \
        [--requests N] [--device cuda]

For each seed it makes the cell's inputs, lets the bfloat16 reference answer
``N`` requests as a run's clients would send them (their seeds, the verified
sample), compares those answers with the float64 reference, and prints the
numbers beside the cell's limits.  The benchmark's own runs never run it; a
limit lies between the program's readings and the control's.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    _root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_root), str(_root / "src")]

import torch  # noqa: E402

from portbench import verify  # noqa: E402
from portbench.harness import (client_pattern, dataset_inputs,  # noqa: E402
                               load_cell)
from portbench.reference import join as ref_join  # noqa: E402

LOWER = torch.bfloat16


def control_numbers(root: Path, name: str, seed: int, requests: int,
                    device="cuda") -> dict:
    """The compared numbers of the control's answers to ``requests``
    requests of a run of cell ``name`` with ``seed``."""
    cell = load_cell(root, name)
    q, tr = cell.config["query"], cell.traffic
    pattern = client_pattern(cell)
    kw = dict(fp_rate=q["fp_rate"], max_strata=q["max_strata"],
              filter_seed=pattern.filter_seed(seed))
    refs, lows = [], []
    for i in range(cell.datasets):
        rels = dataset_inputs(cell, seed, i, device)
        refs.append(ref_join.prepare(rels, **kw))
        lows.append(ref_join.prepare(rels, dtype=LOWER, **kw))
        del rels
    sent, first = pattern.planned(cell, seed, requests)
    got = ref_join.replay(lows, tr["queries"], sent, b_max=q["b_max"])
    verify_at = pattern.verify_indices(seed, tr)
    answers = []
    for j, i in enumerate(range(first, len(sent))):
        low, g = lows[sent[i]["dataset"]], got[i]
        sampled = isinstance(g, ref_join.Sampled)
        a = {"i": i, "live": low.live, "overflow": low.overflow,
             "num_strata": low.num_strata, "sampled": sampled,
             "estimate": g.estimate if sampled else g,
             "bound": g.bound if sampled else 0.0}
        if j in verify_at:
            d = {"keys": low.keys, "valid": low.valid, "counts": low.counts}
            if sampled:
                d.update(starts=low.starts, population=low.population.float(),
                         n_sampled=g.n.float())
            a["detail"] = {k: v.cpu().numpy() for k, v in d.items()}
        answers.append(a)
    return verify.numbers(refs, tr["queries"], sent, answers, requests,
                          b_max=q["b_max"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    limits = load_cell(root, args.workload).limits
    for seed in (int(s) for s in args.seeds.split(",")):
        values = control_numbers(root, args.workload, seed, args.requests,
                                 args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": verify.judge(values, limits)[0],
                          "numbers": values, "limits": limits}), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
