"""The JAX package's join dry run at a small mesh, in a process of its
own: ``python tests/torch_dryrun_join_jax.py <data> <model> <log2 rows>
<out.json>``.

It sets ``XLA_FLAGS`` for ``data x model`` host devices before JAX is
imported, so a test process must run it as a subprocess, never import it.
Writes, for the four records of ``repro.launch.dryrun_join.main`` (exact,
exact without the filter, sample, sample with buckets planned at a 1%
overlap), the collective bytes and calls by kind of each compiled module
(``roofline.collective_bytes`` of its HLO text)."""

import json
import os
import sys

data, model, log2_rows, out = (int(sys.argv[1]), int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                           f"{data * model}")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.launch import dryrun_join as DJ  # noqa: E402
from repro.launch import roofline as RL  # noqa: E402

stats = []
_analyze = RL.analyze


def analyze(compiled, hlo_text, **kw):
    c = RL.collective_bytes(hlo_text, kw.get("default_group", 2))
    stats.append({"bytes": c.bytes_by_kind, "calls": c.count_by_kind})
    return _analyze(compiled, hlo_text, **kw)


RL.analyze = analyze
mesh = Mesh(np.array(jax.devices()[:data * model]).reshape(data, model),
            ("data", "model"))
records = [DJ.run_join_cell(mesh, log2_rows=log2_rows, mode=mode,
                            filter_stage=filt, verbose=False)
           for mode, filt in (("exact", True), ("exact", False),
                              ("sample", True))]
records.append(DJ.run_join_cell(mesh, log2_rows=log2_rows, mode="sample",
                                filter_stage=True, overlap_hint=0.01,
                                verbose=False))
with open(out, "w") as f:
    json.dump([{"operator": r["operator"],
                "coll_bytes_per_device": r["coll_bytes_per_device"], **s}
               for r, s in zip(records, stats)], f)
