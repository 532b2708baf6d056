"""prepare_ms_per_step: the engine's Tracer ``prepare`` spans (join filter,
probe, the per-slot sorts and strata, until the card is done) summed over the
window and divided by its steps."""


def read(rec):
    steps = sum(1 for e in rec.events
                if e["tid"] == "engine" and e["name"] == "step")
    if not steps:
        return None
    return 1e3 * sum(e["dur"] for e in rec.events if e["tid"] == "engine"
                     and e["name"] == "prepare") / steps
