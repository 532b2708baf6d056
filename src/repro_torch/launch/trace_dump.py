"""Summarize a Chrome trace-event JSON written by ``--trace-out``.

The trace file is viewable as-is in ui.perfetto.dev / chrome://tracing;
this CLI is the terminal-side reader: it validates the schema, then prints
per-category event counts, the longest spans, any plan span hierarchies
(recorded by the engine's "plan" instants), and the embedded
modeled-vs-measured byte reconciliation report.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.join_serve \
      --trace-out "$TMPDIR/t.json"
  PYTHONPATH=src python -m repro_torch.launch.trace_dump "$TMPDIR/t.json"
  PYTHONPATH=src python -m repro_torch.launch.trace_dump "$TMPDIR/t.json" \
      --validate-only
"""

from __future__ import annotations

import argparse
import json
from collections import Counter

from repro_torch.runtime.telemetry import format_reconciliation, \
    validate_chrome_trace


def summarize(obj: dict, *, top: int = 10) -> str:
    """Render a validated chrome-trace object as a terminal summary."""
    evs = [e for e in obj["traceEvents"] if e.get("ph") != "M"]
    lines = [f"{len(evs)} events "
             f"({sum(1 for e in evs if e['ph'] == 'X')} spans, "
             f"{sum(1 for e in evs if e['ph'] == 'i')} instants)"]
    by_cat = Counter(e.get("cat", "?") for e in evs)
    lines.append("by category: " + ", ".join(
        f"{c}={n}" for c, n in by_cat.most_common()))
    lanes = {(e.get("pid"), e.get("tid")) for e in evs}
    lines.append(f"lanes: {len(lanes)}")

    spans = sorted((e for e in evs if e["ph"] == "X" and e.get("dur")),
                   key=lambda e: -e["dur"])
    if spans:
        lines.append(f"longest spans (top {min(top, len(spans))}):")
        for e in spans[:top]:
            qid = e.get("args", {}).get("query_id", "")
            tag = f"  [{qid}]" if qid else ""
            lines.append(f"  {e['dur'] / 1e3:10.3f} ms  {e['cat']}/"
                         f"{e['name']}{tag}")

    plans = [e for e in evs
             if e["name"] == "plan" and "hierarchy" in e.get("args", {})]
    for e in plans:
        args = e["args"]
        lines.append(f"plan {args.get('plan', '?')}:")
        for node, refs in args["hierarchy"].items():
            dep = f" <- {', '.join(refs)}" if refs else " (leaf inputs only)"
            lines.append(f"  {node}{dep}")

    recon = obj.get("reconciliation")
    if recon:
        lines.append("byte reconciliation (modeled vs measured):")
        lines.append(format_reconciliation(recon))
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(
        description="validate + summarize a --trace-out chrome trace file")
    ap.add_argument("path", help="trace JSON written by --trace-out")
    ap.add_argument("--validate-only", action="store_true",
                    help="only validate the schema; print the event count")
    ap.add_argument("--top", type=int, default=10,
                    help="longest spans to list (default 10)")
    args = ap.parse_args()
    with open(args.path) as fh:
        obj = json.load(fh)
    n = validate_chrome_trace(obj)
    if args.validate_only:
        print(f"{args.path}: valid chrome trace, {n} events")
        return
    print(summarize(obj, top=args.top))


if __name__ == "__main__":
    main()
