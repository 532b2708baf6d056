"""Split one benchmark cell's served steps by the program's engine spans.

    python3 tools/host_split.py --workload <cell> --seed <n> --seconds <s> \
        [--profile 0|1] [--root <checkout>] [--device cuda|cpu]

Runs the cell once through ``portbench.harness.run_cell`` in this process,
with the program's Tracer over the window as ``--trace 1`` has it; with
``--profile 0`` without torch.profiler, so that the run's ``queries_per_s``
against an untraced run's is the tracer's own cost.  Prints the run's
result line, then one JSON object:

* ``queries_per_s`` of the traced window and ``steps``;
* ``split_ms``: per step, the mean and median ms of each direct child of the
  engine's ``step`` span (``batch-inputs``, ``compile``, ``prepare``,
  ``to-host``, ``decide``, ``sample``, ``exact``, ``finish``), of
  ``sigma-lookup`` and ``sigma-update``, of ``rest`` (a step less its direct
  children) and of ``host`` (a step less ``prepare``, ``sample``, ``exact``
  and ``compile``, as ``host_ms_per_step`` reads it);
* ``to_host``: the copies' bytes a step by what they copy (``totals``,
  each slot's total population, in every step; ``population`` and
  ``strata-keys`` only in a step with a request that is not exact;
  ``sigma``; a mesh's), each step's slots beside its copied bytes, and
  ``keys_step_share``, the share of steps that copied the strata keys;
* ``sorted_rows_pct``: the ``prepare`` spans' ``sorted`` (live rows the
  prepare tail sorted) over their ``rows`` (the real slots' capacity rows
  entering it), in percent; null where the program records neither;
* ``sigma_counts``: the window's sums of the registry spans' counts:
  ``sigma-lookup.strata`` and ``.hits`` (keys looked up, keys found),
  ``sigma-update.strata``, ``.kept`` and ``.new`` (keys offered, stored,
  new to their query); a count the program does not record is left out;
* with the profiler, ``clock``: over the profiled steps' engine spans, the
  gap between a span's start mapped onto the profiler's clock by the
  harness's one anchor (``offset``) and the start of the span's mirrored
  ``record_function`` range (largest absolute, median, spread); and
  ``span_named_ops``: device operations the harness counted that carry a
  program span's name (there should be none).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHILDREN = ("batch-inputs", "compile", "prepare", "to-host", "decide",
            "sample", "exact", "finish")
STAGES = ("prepare", "sample", "exact", "compile")


def _stats(values: list) -> dict:
    return {"mean": statistics.fmean(values) if values else 0.0,
            "median": statistics.median(values) if values else 0.0}


def split(events: list, span_tree) -> dict:
    """The per-step split of the engine lane's spans."""
    steps = [n for n in span_tree(e for e in events if e["tid"] == "engine")
             if n["name"] == "step"]
    parts: dict = {k: [] for k in CHILDREN + ("sigma-lookup",
                                              "sigma-update", "rest",
                                              "host")}
    by_what: dict = {}
    widths: dict = {}
    counts: dict = {}
    keys_steps = 0
    tail = {"rows": 0, "sorted": 0}
    for s in steps:
        got = {k: 0.0 for k in parts}
        copied = 0
        slots = None
        for c in s["children"]:
            if c["name"] in CHILDREN:
                got[c["name"]] += c["dur"]
            if c["name"] == "batch-inputs":
                slots = c["args"]["slots"]
            if c["name"] == "prepare":
                for a in tail:
                    tail[a] += c["args"].get(a, 0)
            for g in [c] + c["children"]:
                if g["name"] in ("sigma-lookup", "sigma-update"):
                    got[g["name"]] += g["dur"]
                    for a in ("strata", "hits", "kept", "new"):
                        key = f"{g['name']}.{a}"
                        if a in g["args"]:
                            counts[key] = counts.get(key, 0) + g["args"][a]
                if g["name"] == "to-host":
                    what = g["args"]["what"]
                    by_what[what] = by_what.get(what, 0) + g["args"]["bytes"]
                    copied += g["args"]["bytes"]
                    keys_steps += what == "strata-keys"
        got["rest"] = s["dur"] - sum(c["dur"] for c in s["children"])
        got["host"] = s["dur"] - sum(c["dur"] for c in s["children"]
                                     if c["name"] in STAGES)
        for k, v in got.items():
            parts[k].append(1e3 * v)
        widths.setdefault(str(slots), set()).add(copied)
    n = max(len(steps), 1)
    return {"steps": len(steps),
            "split_ms": {k: _stats(v) for k, v in parts.items()},
            "sorted_rows_pct": (100 * tail["sorted"] / tail["rows"]
                                if tail["rows"] else None),
            "sigma_counts": counts,
            "to_host": {"bytes_per_step": {k: v / n
                                           for k, v in by_what.items()},
                        "bytes_by_slots": {k: sorted(v)
                                           for k, v in widths.items()},
                        "keys_step_share": keys_steps / n}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(ROOT / "src")]

    from portbench import harness
    from repro_torch.runtime import telemetry

    records, mirrored, profiles = [], [], []

    Records = harness.Records

    def keep(*a, **k):
        records.append(Records(*a, **k))
        return records[-1]

    class Profile(harness.Profile):
        """The harness's profile, keeping its host ranges' starts."""

        def __init__(self, *a):
            super().__init__(*a)
            profiles.append(self)

        def read(self):
            from torch.autograd import DeviceType
            mirrored.extend((e.name, e.time_range.start / 1e6)
                            for e in self.prof.events()
                            if e.device_type == DeviceType.CPU)
            super().read()

    class NoProfile:
        """A profile that never begins: the tracer alone."""
        prof, active, done, result = True, False, False, None

        def __init__(self, *a):
            self.step_info = []

        def warm(self):
            pass

    harness.Profile = Profile if args.profile else NoProfile
    harness.Records = keep
    result = harness.run_cell(root, args.workload, args.seed, args.seconds,
                              True, device=args.device)
    harness.Records = Records
    print(json.dumps(result), flush=True)

    rec = records[-1]
    out = {"workload": args.workload, "seed": args.seed,
           "profile": args.profile,
           "queries_per_s": harness.reader(root / "portbench",
                                           "queries_per_s")(rec)}
    out.update(split(rec.events, telemetry.span_tree))
    if profiles and profiles[-1].result is not None:
        d = profiles[-1].result
        names = {e["name"] for e in rec.events if e["tid"] == "engine"
                 and e["dur"] is not None}
        gaps, unpaired = [], 0
        for name in sorted(names):
            # the spans begun inside the profile, each beside its range
            spans = sorted(e["ts"] for e in rec.events
                           if e["tid"] == "engine" and e["name"] == name
                           and e["dur"] is not None
                           and e["ts"] >= profiles[-1].t_pc)
            ranges = sorted(t for n, t in mirrored if n == name)
            unpaired += abs(len(spans) - len(ranges))
            gaps += [1e3 * ((t - d["offset"]) - r)
                     for t, r in zip(spans, ranges)]
        out["clock"] = {
            "spans": len(gaps), "unpaired": unpaired,
            "largest_abs_ms": max(map(abs, gaps)) if gaps else None,
            "median_ms": statistics.median(gaps) if gaps else None,
            "spread_ms": max(gaps) - min(gaps) if gaps else None}
        out["span_named_ops"] = sorted({n for n, _, _ in d["ops"]
                                        if n in names})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
