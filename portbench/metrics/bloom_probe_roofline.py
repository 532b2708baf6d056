"""bloom_probe_roofline: the probe's bytes (``yardstick.bloom_probe_bytes``
of each launch: one an input and step, over the step's slots, the input's
capacity and the filter's blocks) at 3.35 TB/s, over the profiler's device
time of the kernels named below, in percent of the roofline."""

import re

from portbench.yardstick import bloom_probe_bytes, roofline_pct

KERNELS = ("bloom_probe_kernel",)
_NAME = re.compile(r"(^|::)(%s)(\(|<|$)" % "|".join(KERNELS))


def read(rec):
    d = rec.device
    if d is None:
        return None
    ops = [b - a for name, a, b in d["ops"] if _NAME.search(name)]
    launches = [(s["width"], cap, s["num_blocks"])
                for s in d["steps"] for cap in s["caps"]]
    if not ops or len(ops) != len(launches):
        return None
    return roofline_pct(sum(bloom_probe_bytes(*x) for x in launches), sum(ops))
