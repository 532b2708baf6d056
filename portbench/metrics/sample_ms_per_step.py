"""sample_ms_per_step: the engine's Tracer ``sample`` spans (the sampler
kernel and the estimates, until the card is done) summed over the window and
divided by its steps; nothing where no step sampled."""


def read(rec):
    eng = [e for e in rec.events if e["tid"] == "engine"]
    steps = sum(1 for e in eng if e["name"] == "step")
    sample = [e["dur"] for e in eng if e["name"] == "sample"]
    if not steps or not sample:
        return None
    return 1e3 * sum(sample) / steps
