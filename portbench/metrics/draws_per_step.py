"""draws_per_step: the edges a served step draws, in millions: the ``draws``
of the engine's Tracer ``draws`` instants (the sampler's ``n_sampled`` over
each sampled slot's joinable strata, one a step that sampled) summed
over the window and divided by its steps; nothing where no instant carries
them."""


def read(rec):
    eng = [e for e in rec.events if e["tid"] == "engine"]
    steps = sum(1 for e in eng if e["name"] == "step")
    draws = [e["args"]["draws"] for e in eng if e["name"] == "draws"]
    if not steps or not draws:
        return None
    return sum(draws) / 1e6 / steps
