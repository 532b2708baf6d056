"""Aggregate dry-run records (``launch/dryrun.py``) into markdown roofline
tables: the JAX package's ``launch/report.py``, the same tables from the
same records.

  PYTHONPATH=src python -m repro_torch.launch.report \
      [--baseline experiments/dryrun_torch] \
      [--optimized experiments/dryrun_torch_optimized] [--mac-fix]

``--mac-fix`` doubles the baseline's compute term, for records whose flops
count a multiply-add once (the JAX package's records made before its
MAC->FLOP fix); the port's flop counter counts 2 per multiply-add, so its
own records never need it.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load(dirname: str, mac_fix: bool) -> dict:
    out = {}
    for fn in glob.glob(os.path.join(dirname, "*.json")):
        r = json.load(open(fn))
        key = (r["arch"], r["shape"],
               "multi" if "pod" in r["mesh"] else "single")
        if r["status"] != "ok":
            out[key] = r
            continue
        if mac_fix:
            r["roofline"]["compute_s"] *= 2.0
            rf = r["roofline"]
            terms = {"compute": rf["compute_s"], "memory": rf["memory_s"],
                     "collective": rf["collective_s"]}
            rf["dominant"] = max(terms, key=terms.get)
        out[key] = r
    return out


def fmt_row(r: dict) -> str:
    if r["status"] == "skipped":
        return f"| {r['arch']} | {r['shape']} | skipped | — | — | — | — | — |"
    rf = r["roofline"]
    step = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
    frac = rf["compute_s"] / step if step else 0.0
    return (f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.3e} "
            f"| {rf['memory_s']:.3e} | {rf['collective_s']:.3e} "
            f"| {rf['dominant']} | {frac:.2f} "
            f"| {rf['useful_fraction']:.2f} |")


HEADER = ("| arch | shape | compute (s) | memory (s) | collective (s) "
          "| dominant | roofline frac | useful frac |\n"
          "|---|---|---|---|---|---|---|---|")


def table(records: dict, mesh: str) -> str:
    rows = [HEADER]
    for key in sorted(records):
        if key[2] != mesh:
            continue
        rows.append(fmt_row(records[key]))
    return "\n".join(rows)


def deltas(base: dict, opt: dict) -> str:
    rows = ["| arch | shape | dominant term before -> after | speedup |",
            "|---|---|---|---|"]
    for key in sorted(base):
        if key[2] != "single":
            continue
        b, o = base.get(key), opt.get(key)
        if not b or not o or b["status"] != "ok" or o["status"] != "ok":
            continue
        bstep = max(b["roofline"]["compute_s"], b["roofline"]["memory_s"],
                    b["roofline"]["collective_s"])
        ostep = max(o["roofline"]["compute_s"], o["roofline"]["memory_s"],
                    o["roofline"]["collective_s"])
        if bstep / max(ostep, 1e-12) < 1.05 and ostep / max(bstep, 1e-12) < 1.05:
            continue
        rows.append(f"| {key[0]} | {key[1]} | {bstep:.3e} -> {ostep:.3e} "
                    f"| {bstep / max(ostep, 1e-12):.2f}x |")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default="experiments/dryrun_torch")
    ap.add_argument("--optimized",
                    default="experiments/dryrun_torch_optimized")
    ap.add_argument("--mac-fix", action="store_true")
    args = ap.parse_args(argv)
    base = load(args.baseline, mac_fix=args.mac_fix)
    print("## Baseline roofline — single-pod (16x16), per-device terms\n")
    print(table(base, "single"))
    if os.path.isdir(args.optimized):
        opt = load(args.optimized, mac_fix=False)
        print("\n## Optimized roofline — single-pod\n")
        print(table(opt, "single"))
        print("\n## Dominant-term speedups (baseline -> optimized)\n")
        print(deltas(base, opt))
        print("\n## Optimized roofline — multi-pod (2x16x16)\n")
        print(table(opt, "multi"))


if __name__ == "__main__":
    main()
