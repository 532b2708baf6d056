"""device_idle_pct: 100 x (1 - the union of the device's kernel and memory
operations over the profiled steps' wall time), from torch.profiler's trace
of a few steady steps of the traced window."""

from portbench.yardstick import busy_seconds


def read(rec):
    d = rec.device
    if d is None or not d["ops"] or d["hi"] <= d["lo"]:
        return None
    busy = busy_seconds([(a, b) for _, a, b in d["ops"]], d["lo"], d["hi"])
    return 100.0 * (1.0 - busy / (d["hi"] - d["lo"]))
