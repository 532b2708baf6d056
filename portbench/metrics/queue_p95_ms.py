"""queue_p95_ms: the 95th percentile, over every request answered in the
window, of the program's ``JoinRequest.queue_latency_s`` (ingest to dispatch
by the batch former)."""

from portbench.yardstick import p95


def read(rec):
    v = p95([r["queue_s"] for r in rec.requests])
    return None if v is None else 1e3 * v
