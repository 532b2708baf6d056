"""sigma_ms_per_step: the SigmaRegistry's time in a served step: the engine's
Tracer ``sigma-lookup`` spans (inside ``decide``: the registry's sigmas of a
request's strata keys) and ``sigma-update`` spans (inside ``finish``: the
measured sigmas stored, without their copies to the host) summed over the
window and divided by its steps; nothing where no step looked up or updated
a sigma."""

SPANS = ("sigma-lookup", "sigma-update")


def read(rec):
    eng = [e for e in rec.events if e["tid"] == "engine"]
    steps = sum(1 for e in eng if e["name"] == "step")
    sigma = [e["dur"] for e in eng if e["name"] in SPANS]
    if not steps or not sigma:
        return None
    return 1e3 * sum(sigma) / steps
