"""e2e_p95_ms: the 95th percentile, over every request answered in the
window, of the time from the client's submit to its answer's numbers being on
the host (host clock)."""

from portbench.yardstick import p95


def read(rec):
    v = p95([r["e2e_s"] for r in rec.requests])
    return None if v is None else 1e3 * v
