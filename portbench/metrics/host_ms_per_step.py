"""host_ms_per_step: the host's own time in a served step: each Tracer
``step`` span of the engine less the ``prepare``, ``sample``, ``exact`` and
``compile`` spans inside it, summed over the window and divided by its steps.
What is left is batch inputs, the budget's ``b_i`` with the SigmaRegistry
lookups, and result assembly with the sigma updates."""

STAGES = ("prepare", "sample", "exact", "compile")


def read(rec):
    eng = [e for e in rec.events if e["tid"] == "engine" and e["dur"]]
    steps = [e for e in eng if e["name"] == "step"]
    if not steps:
        return None
    stages = [e for e in eng if e["name"] in STAGES]
    host = 0.0
    for s in steps:
        lo, hi = s["ts"], s["ts"] + s["dur"]
        host += s["dur"] - sum(e["dur"] for e in stages
                               if lo <= e["ts"] and e["ts"] + e["dur"] <= hi)
    return 1e3 * host / len(steps)
