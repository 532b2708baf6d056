"""slots_per_step: requests served over the window's ``JoinServer.step()``
calls that served any."""


def read(rec):
    served = [s["served"] for s in rec.steps if s["served"]]
    return sum(served) / len(served) if served else None
