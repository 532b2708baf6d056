"""The port's join dry run (``launch/dryrun_join.py``) against the JAX
package's, at a ``(2, 4)`` mesh and 2^16 rows: the port as rank 0 of 8
fake ranks on the CPU, the reference compiled for 8 host devices in a
process of its own (``tests/torch_dryrun_join_jax.py``).

The four records (exact, exact without the filter, sample, sample with
buckets planned at a 1% overlap) must carry the same collective bytes by
kind, up to differences each asserted exactly and named:

* all_to_all: the reference's shuffle slot carries a 1-byte ``valid`` flag
  beside its 4-byte key and value, the port's none (an empty slot holds the
  sentinel key): its bytes are the port's x 9/8.  It sends the three
  arrays of each relation over each axis (12 calls), the port one stacked
  exchange an axis (2);
* all_gather: the same bytes, in twice the calls: the reference gathers
  as separate arrays what the port stacks into one int32 gather an axis;
* all_reduce: the port sums its counts as int64 (the reference, x64 off,
  int32), over one axis and then the other, and sums eagerly the values
  whose sum the reference's compiled program drops as unused; XLA combines
  the reference's into 2 all-reduces over the whole mesh.  Each side's
  bytes are a ring's over its own payload: 2 (k - 1) / k of it over each
  axis for the port (2.5 x over 2 then 4 ranks), 1.75 x over 8 for the
  reference.
"""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun_join as DJ
from repro_torch.launch.mesh import fake_ranks, make_host_mesh
from torch_accuracy import one_torch_thread  # noqa: F401  (autouse)

MESH = (2, 4)
LOG2_ROWS = 16
HERE = os.path.dirname(os.path.abspath(__file__))
# the all_reduce payloads (bytes) of each record: the port's (its psums:
# counts and lives int64 32, bucket overflow int64 8, the population f32 4;
# exact: the sums and count f32 8; sample: the sum parts and count f32 24
# and the draws f32 4) and the reference's compiled program's
PORT_PAYLOAD = (52, 52, 72, 72)
REF_PAYLOAD = (28, 20, 48, 48)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("djax") / "jax.json")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [os.path.join(HERE, "..", "src"),
                os.environ.get("PYTHONPATH", "")])}
    subprocess.run([sys.executable,
                    os.path.join(HERE, "torch_dryrun_join_jax.py"),
                    *map(str, MESH), str(LOG2_ROWS), out], check=True,
                   env=env, timeout=300)
    with open(out) as f:
        ref = json.load(f)
    with fake_ranks(MESH[0] * MESH[1]):
        mesh = make_host_mesh(*MESH)
        rels = DJ.rank_rows((1 << LOG2_ROWS) // (MESH[0] * MESH[1]), 0,
                            "cpu")
        port = DJ.run_variants(mesh, rels, LOG2_ROWS, verbose=False)
    return ref, port


def _by_kind(census: list) -> tuple:
    nbytes, calls = {}, {}
    for c in census:
        nbytes[c["kind"]] = nbytes.get(c["kind"], 0) + c["bytes"]
        calls[c["kind"]] = calls.get(c["kind"], 0) + c["calls"]
    return nbytes, calls


def test_join_census_matches_the_reference(both):
    ref, port = both
    assert [r["operator"] for r in port] == [
        "approxjoin[exact]", "approxjoin[exact,nofilter]",
        "approxjoin[sample]", "approxjoin[sample,cap-planned]"]
    for i, (j, p) in enumerate(zip(ref, port)):
        nbytes, calls = _by_kind(p["census"])
        name = p["operator"]
        assert nbytes["all_gather"] == j["bytes"]["all-gather"], name
        assert calls["all_gather"] * 2 == j["calls"]["all-gather"], name
        assert nbytes["all_to_all"] * 9 / 8 == j["bytes"]["all-to-all"], name
        assert calls["all_to_all"] == 2 and j["calls"]["all-to-all"] == 12
        assert nbytes["all_reduce"] == 2.5 * PORT_PAYLOAD[i], name
        assert j["bytes"]["all-reduce"] == 1.75 * REF_PAYLOAD[i], name
        assert j["calls"]["all-reduce"] == 2
        assert calls["all_reduce"] == (8 if "exact" in name else 10), name
        assert j["bytes"]["reduce-scatter"] == 0 == nbytes.get(
            "reduce_scatter", 0)
        assert p["coll_bytes_per_device"] == sum(nbytes.values())
        assert p["launches"] == {k: 0 for k in DJ.KERNELS}   # CPU tensors


def test_planned_ratio_and_kernel_bytes(both):
    _, port = both
    # the naive sample's shuffle is the whole input, the planned one's the
    # 1% overlap with its slack: only the all_to_all shrinks
    assert DJ.planned_ratio(port) == pytest.approx(
        port[2]["coll_bytes_per_device"] / port[3]["coll_bytes_per_device"])
    a2a = [_by_kind(p["census"])[0]["all_to_all"] for p in port]
    assert a2a[3] < a2a[2] == a2a[0] == a2a[1]
    for p in port:
        assert p["kernel_bytes"] == {}      # no kernel launched on the CPU
        assert p["hbm_bytes_per_device"] > 0 and p["peak_bytes"] > 0
        assert p["nvlink_bytes_per_device"] == p["coll_bytes_per_device"]
        assert p["network_bytes_per_device"] == 0
