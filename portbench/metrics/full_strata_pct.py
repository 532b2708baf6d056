"""full_strata_pct: the share of the sampled slots' joinable strata that a
step draws in full (the sampler's ``n_sampled`` reaches the stratum's
population), in %: the ``full`` over the ``joinable`` of the engine's Tracer
``draws`` instants, each summed over the window; nothing where none
carries them or no sampled slot had a joinable stratum."""


def read(rec):
    counts = [e["args"] for e in rec.events
              if e["tid"] == "engine" and e["name"] == "draws"]
    joinable = sum(a["joinable"] for a in counts)
    if not joinable:
        return None
    return 100.0 * sum(a["full"] for a in counts) / joinable
