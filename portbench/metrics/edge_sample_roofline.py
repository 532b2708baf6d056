"""edge_sample_roofline: the sampler's bytes (``yardstick.edge_sample_bytes``
of each launch: one a sampling step, over the step's slots, the strata
capacity and the values its draws read) at 3.35 TB/s, over the profiler's
device time of the two kernels named below, in percent of the roofline."""

import re

from portbench.yardstick import edge_sample_bytes, roofline_pct

KERNELS = ("plan_kernel", "sample_kernel")
_NAME = re.compile(r"(^|::)(%s)(\(|<|$)" % "|".join(KERNELS))


def read(rec):
    d = rec.device
    if d is None:
        return None
    ops = [b - a for name, a, b in d["ops"] if _NAME.search(name)]
    launches = [s for s in d["steps"] if "gathered" in s]
    if not ops or len(ops) != len(KERNELS) * len(launches):
        return None
    return roofline_pct(sum(edge_sample_bytes(s["width"], s["max_strata"],
                                              s["gathered"])
                            for s in launches), sum(ops))
