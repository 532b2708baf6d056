"""to_host_ms_per_step: the engine's Tracer ``to-host`` spans (each copy a
served step makes to the host: the strata populations and keys, each sampled
request's sigmas and their validity, on a mesh its meters; the wait for the
card's work before a copy included) summed over the window and divided by its
steps; nothing where no step copied."""


def read(rec):
    eng = [e for e in rec.events if e["tid"] == "engine"]
    steps = sum(1 for e in eng if e["name"] == "step")
    copies = [e["dur"] for e in eng if e["name"] == "to-host"]
    if not steps or not copies:
        return None
    return 1e3 * sum(copies) / steps
