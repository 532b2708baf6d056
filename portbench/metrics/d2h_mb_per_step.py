"""d2h_mb_per_step: the bytes a served step copies to the host, in MB (10^6
bytes): the ``bytes`` of the engine's Tracer ``to-host`` spans (the copied
tensors' ``nbytes``) summed over the window and divided by its steps; nothing
where no step copied."""


def read(rec):
    eng = [e for e in rec.events if e["tid"] == "engine"]
    steps = sum(1 for e in eng if e["name"] == "step")
    copied = [e["args"]["bytes"] for e in eng if e["name"] == "to-host"]
    if not steps or not copied:
        return None
    return sum(copied) / 1e6 / steps
